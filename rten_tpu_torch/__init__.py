"""rten_tpu_torch — the PyTorch and CUDA port of rten_tpu for NVIDIA Hopper.

The JAX package ``rten_tpu`` is the reference; this package runs beside it
and imports nothing of it (and never ``jax``). So far it carries the main
path: GPT-2-class INT8 prefill (a prompt as one forward) and greedy decode
over a preallocated KV cache, bf16 or int8, with int8 weights only or, with
``DecoderConfig(w8a8=True)``, int8 activations too (``models.decoder``,
``generate``), and continuous-batching serving over slot or paged KV caches
with an HTTP API (``serve``), the Whisper-class encoder-decoder, the BERT,
wav2vec2 (with ``ctc`` and ``audio``), ViT, MobileNetV2 and ResNet models
(``models``, ``image``), the graph runtime (``graph``, ``ops``,
``optimize``, ``runtime``: a ``Model`` of ONNX-style ops, interpreted or
captured as one CUDA graph a signature, and ``generate.GraphBackend``), and
model files (``format``: `.rten` load and save, ONNX import; ``convert``;
``cli``; ``models.lift`` with ``generate.backend_for_model``, which lifts a
file's weights onto the decoders' dense-weight route), on hand-written CUDA
kernels for ``sm_90a`` (``kernels``). Entry points run on the card by default
(``device="cuda"``) and run the kernels' plain PyTorch versions when asked
for ``device="cpu"``.
"""

__version__ = "0.1.0"
