"""RESCAL's projection products and their gradients (csrc/rescal_proj.cu)."""
