"""Autoregressive generation over the port's models: ``Generator`` with a
``NativeBackend`` (the decoder), an ``EncDecBackend`` (the Whisper-class
encoder-decoder) or a ``GraphBackend`` (a graph ``Model``;
``backend_for_model`` picks one for a loaded model), samplers, speculative
decoding and metrics."""

from rten_tpu_torch.generate.generator import (
    EncDecBackend,
    EncDecBackendFactory,
    Generator,
    GeneratorConfig,
    GraphBackend,
    NativeBackend,
    backend_for_model,
)
from rten_tpu_torch.generate.metrics import Metrics
from rten_tpu_torch.generate.sampler import ArgMaxSampler, Sampler, TemperatureSampler, TopKSampler, TopPSampler

__all__ = ["Generator", "GeneratorConfig", "NativeBackend", "GraphBackend", "EncDecBackend", "EncDecBackendFactory",
           "backend_for_model", "Metrics",
           "Sampler", "ArgMaxSampler", "TemperatureSampler", "TopKSampler", "TopPSampler"]
