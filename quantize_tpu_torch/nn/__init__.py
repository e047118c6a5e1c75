"""Quantization-aware modules, config resolution and packed precision."""
