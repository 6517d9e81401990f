"""EnCodec 24 kHz codec: SEANet encoder + residual VQ, and the decoder."""
