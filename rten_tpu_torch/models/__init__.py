"""Native models of the port: the GPT-2 / OPT / Llama-class decoder
(``decoder``) and the Whisper-class encoder-decoder
(``encoder_decoder``)."""

from rten_tpu_torch.models import decoder, encoder_decoder

__all__ = ["decoder", "encoder_decoder"]
