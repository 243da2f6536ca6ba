"""Gradient compression of the LM trainer: Ranky-GaLore."""
