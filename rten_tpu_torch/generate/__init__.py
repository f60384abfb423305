"""Autoregressive generation over the port's decoder: ``Generator`` with a
``NativeBackend``, samplers, speculative decoding and metrics."""

from rten_tpu_torch.generate.generator import Generator, GeneratorConfig, NativeBackend
from rten_tpu_torch.generate.metrics import Metrics
from rten_tpu_torch.generate.sampler import ArgMaxSampler, Sampler, TemperatureSampler, TopKSampler, TopPSampler

__all__ = ["Generator", "GeneratorConfig", "NativeBackend", "Metrics", "Sampler", "ArgMaxSampler",
           "TemperatureSampler", "TopKSampler", "TopPSampler"]
