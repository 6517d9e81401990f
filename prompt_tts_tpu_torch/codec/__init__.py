"""EnCodec 24 kHz codec, decode side (RVQ dequantize + SEANet decoder)."""
