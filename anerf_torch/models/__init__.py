"""The A-NeRF MLP (torch)."""
