"""Subpackage of bobe_tpu_torch."""
