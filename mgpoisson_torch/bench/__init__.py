"""Measurement tools for the port (``profile``: one solve under
torch.profiler)."""
