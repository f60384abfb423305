"""Native models of the port: the GPT-2 / OPT / Llama-class decoder
(``decoder``), the Whisper-class encoder-decoder (``encoder_decoder``), the
BERT-class and wav2vec2 encoders (``bert``, ``wav2vec2``) and the vision
models (``vit``, ``mobilenet``, ``resnet``); ``ieee`` holds their IEEE-f32
convolutions and dense matmuls; ``gpt2_graph`` writes a GPT-2 decoder as a
graph for the graph runtime; ``lift`` lifts a loaded graph's HF-named
weights onto the decoders."""

from rten_tpu_torch.models import (bert, decoder, encoder_decoder, gpt2_graph, ieee, lift, mobilenet, resnet, vit,
                                   wav2vec2)

__all__ = ["bert", "decoder", "encoder_decoder", "gpt2_graph", "ieee", "lift", "mobilenet", "resnet", "vit", "wav2vec2"]
