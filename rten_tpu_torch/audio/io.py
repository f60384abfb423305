"""Audio file ⇄ float32 waveforms: a numpy copy of ``rten_tpu/audio/io.py``,
so that the port reads speech for ``models.wav2vec2`` without the JAX
package.

The reference's speech examples read .wav files via the `hound` crate
(rten-examples/src/wav2vec2.rs:25-40, rten-examples/Cargo.toml:13) and the
TTS example writes one back (rten-examples/src/piper.rs). This module is the
stdlib-`wave` counterpart: 8/16/24/32-bit integer PCM and 32-bit float PCM
in, 16-bit PCM out, mono downmix, and a linear resampler for matching a
model's expected sample rate (wav2vec2-class models want 16 kHz).
"""

from __future__ import annotations

import wave

import numpy as np

_PCM, _IEEE_FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE


def _parse_riff(path: str) -> tuple[int, int, int, int, bytes]:
    """Minimal RIFF/WAVE parser → (format_tag, n_channels, sample_rate,
    bits_per_sample, data bytes). stdlib ``wave`` rejects IEEE-float files
    (format tag 3 raises ``wave.Error`` on every CPython version), and its
    sampwidth alone cannot distinguish int32 PCM from float32 — the fmt
    chunk's tag can, so parse it directly."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = data = None
        while fmt is None or data is None:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[:4]
            size = int.from_bytes(hdr[4:8], "little")
            chunk = f.read(size)
            if cid == b"fmt ":
                fmt = chunk
            elif cid == b"data":
                data = chunk
            if size % 2:  # chunks are word-aligned
                f.read(1)
    if fmt is None or len(fmt) < 16 or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag = int.from_bytes(fmt[0:2], "little")
    n_ch = int.from_bytes(fmt[2:4], "little")
    sr = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if tag == _EXTENSIBLE and len(fmt) >= 26:
        tag = int.from_bytes(fmt[24:26], "little")  # SubFormat GUID head
    return tag, n_ch, sr, bits, data


def read_wav(path: str, *, mono: bool = True) -> tuple[np.ndarray, int]:
    """Read a .wav file → (float32 waveform in [-1, 1], sample_rate).

    Mono output is [N]; with ``mono=False`` multi-channel files come back as
    [channels, N]. Supports 8-bit unsigned, 16/24/32-bit signed integer PCM,
    IEEE float32/float64 (format tag 3), and the WAVE_FORMAT_EXTENSIBLE
    wrappers of both.
    """
    tag, n_ch, sr, bits, raw = _parse_riff(path)

    if tag == _IEEE_FLOAT:
        if bits == 32:
            data = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits == 64:
            data = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float wav bit depth: {bits}")
    elif tag != _PCM:
        raise ValueError(f"unsupported wav format tag: {tag}")
    elif bits == 8:  # 8-bit PCM is unsigned
        data = np.frombuffer(raw, np.uint8).astype(np.float32)
        data = (data - 128.0) / 128.0
    elif bits == 16:
        # ÷32767 (not 32768) so write_wav→read_wav round-trips exactly up
        # to quantization; full-scale -32768 decodes marginally below -1.
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
    elif bits == 24:  # packed: widen to i32 then shift
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
        data = i32.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported wav bit depth: {bits}")

    if n_ch > 1:
        data = data.reshape(-1, n_ch).T  # [C, N]
        if mono:
            data = data.mean(axis=0)
    return np.ascontiguousarray(data, np.float32), sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write a float32 waveform in [-1, 1] as 16-bit PCM. [N] writes mono;
    [C, N] writes C channels."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    if wav.ndim != 2:
        raise ValueError(f"waveform must be [N] or [C, N], got {wav.shape}")
    n_ch = wav.shape[0]
    pcm = np.clip(np.round(wav * 32767.0), -32768, 32767).astype("<i2")
    interleaved = np.ascontiguousarray(pcm.T)  # [N, C]
    with wave.open(path, "wb") as wf:
        wf.setnchannels(n_ch)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(interleaved.tobytes())


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear-interpolation resample along the last axis (enough for speech
    feature extraction; matches what the examples need to feed 16 kHz
    models from arbitrary-rate files)."""
    wav = np.asarray(wav, np.float32)
    if sr == target_sr:
        return wav
    n = wav.shape[-1]
    m = max(1, int(round(n * target_sr / sr)))
    # Rate-exact mapping (output sample i sits at input time i·sr/target):
    # endpoint-aligned (n-1)/(m-1) spacing would drift the phase by up to a
    # full sample across the clip.
    src_pos = np.minimum(
        np.arange(m, dtype=np.float64) * (sr / target_sr), n - 1
    )
    lo = np.floor(src_pos).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    frac = (src_pos - lo).astype(np.float32)
    out = wav[..., lo] * (1.0 - frac) + wav[..., hi] * frac
    return np.ascontiguousarray(out, np.float32)
