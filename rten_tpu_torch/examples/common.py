"""Shared helpers for the example applications: the port's copy of
``examples/common.py``.

Every example supports ``--demo``: seeded synthetic weights + inputs so the
full pipeline (pre-processing → model → post-processing) runs end-to-end
without downloading checkpoints, mirroring how the reference CLI
synthesizes inputs from declared shapes (rten-cli/src/main.rs:100). Every
example runs on the card unless given ``--cpu``, which passes
``device="cpu"`` down to every entry point it calls.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--demo",
        action="store_true",
        help="run with seeded synthetic weights + inputs (no checkpoint files)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the host through the kernels' plain versions")
    return p


def synthetic_image(h: int = 224, w: int = 224, seed: int = 0) -> np.ndarray:
    """Deterministic CHW float32 test image in [0, 1]: smooth gradients with a
    bright rectangle and a dark disk (gives detectors/segmenters structure)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 13.0) * np.cos(yy / 17.0)]
    )
    base += 0.05 * rng.standard_normal((3, h, w)).astype(np.float32)
    # bright rectangle
    base[:, h // 4 : h // 2, w // 8 : w // 3] = 0.9
    # dark disk
    cy, cx, r = int(h * 0.65), int(w * 0.7), min(h, w) // 6
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    base[:, mask] = 0.1
    return np.clip(base, 0.0, 1.0)


def synthetic_audio(
    seconds: float = 2.0, sr: int = 16000, seed: int = 0
) -> tuple[np.ndarray, int]:
    """Mono f32 waveform: silence with two 'speech' bursts (modulated tones +
    noise) — enough signal for VAD/ASR demo pipelines."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    wav = 0.005 * rng.standard_normal(n).astype(np.float32)
    t = np.arange(n) / sr
    for start, dur in ((0.3, 0.5), (1.2, 0.4)):
        s, e = int(start * sr), int((start + dur) * sr)
        seg = t[s:e]
        tone = 0.4 * np.sin(2 * np.pi * 220 * seg) * (1 + 0.5 * np.sin(2 * np.pi * 3 * seg))
        wav[s:e] += tone.astype(np.float32)
    return wav, sr


def resize_bilinear(x, size):
    """``x`` [..., h, w] (a tensor, or a numpy array taken to the CPU)
    resized over its last two axes to ``size`` (H, W) in f32 on its device:
    what ``jax.image.resize(x, (..., H, W), "bilinear")`` computes, the
    triangle filter widened when it shrinks (``antialias=True``; PyTorch's
    plain bilinear samples without it and differs by up to ~0.6 there)."""
    import torch
    import torch.nn.functional as F

    t = torch.as_tensor(x).float()
    lead, (h, w) = t.shape[:-2], t.shape[-2:]
    if (h, w) == tuple(size):
        return t
    out = F.interpolate(t.reshape(-1, 1, h, w), size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.reshape(*lead, *size)


def load_image_arg(path: str, size: int | None = None) -> np.ndarray:
    """Read an image file as CHW f32 in [0, 1] (``image.io`` ≙
    rten-imageio), bilinearly resized to size×size when asked — the
    examples' real-input path (reference: imagenet.rs:56-100)."""
    from rten_tpu_torch.image.io import read_image

    chw = read_image(path)
    if size is not None and chw.shape[1:] != (size, size):
        chw = resize_bilinear(chw, (size, size)).numpy()
    return chw


def to_numpy(t) -> np.ndarray:
    """A model output as a host f32 numpy array (one copy from the card)."""
    return t.detach().float().cpu().numpy()


def word_vocab(words: list[str]) -> dict[str, int]:
    """WordPiece-style vocab over whole words + specials."""
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
    for w in words:
        if w not in vocab:
            vocab[w] = len(vocab)
    return vocab


def run_main(main, argv=None):
    sys.exit(main(argv))


def load_state_npz(path: str) -> dict:
    """Load a checkpoint state dict saved as .npz (numpy arrays keyed by the
    upstream parameter names) — the examples' real-weight path. The model
    importers (models/*.from_hf_*) accept numpy arrays directly:

        state = {k: v.numpy() for k, v in torch_model.state_dict().items()}
        np.savez(path, **state)
    """
    data = np.load(path)
    return {k: data[k] for k in data.files}


def strip_prefix(state: dict, prefix: str) -> dict:
    """Strip a wrapper prefix (e.g. "bert." on BertForQuestionAnswering
    checkpoints) from every matching key."""
    out = {}
    for k, v in state.items():
        out[k[len(prefix):] if k.startswith(prefix) else k] = v
    return out
