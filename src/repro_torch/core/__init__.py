"""Quantization, model specs and the control program (schedule)."""
