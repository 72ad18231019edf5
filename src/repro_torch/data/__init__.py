"""Data: the decoder as a VLM input pipeline
(:mod:`~repro_torch.data.jpeg_pipeline`) and the token data
(:mod:`~repro_torch.data.tokens`)."""
