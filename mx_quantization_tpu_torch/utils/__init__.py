"""Weight loading and offline pre-quantization."""
