"""Audio I/O: a copy of ``rten_tpu/audio`` (the .wav paths of the
reference's speech examples)."""

from rten_tpu_torch.audio.io import read_wav, resample, write_wav

__all__ = ["read_wav", "write_wav", "resample"]
