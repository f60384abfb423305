"""Native models of the port: the GPT-2-class decoder (``decoder``)."""
