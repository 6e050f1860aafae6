"""Roofline terms of one device and the collectives of a cell's step (the
port of ``repro/roofline``; the hardware is the H100's)."""
from .collectives import collective_bytes, step_collectives
from .model import HW_H100, Hardware, model_flops, roofline_terms

__all__ = ["HW_H100", "Hardware", "collective_bytes", "model_flops",
           "roofline_terms", "step_collectives"]
