"""The train step (torch): losses, optimizer state, the dual-optimizer step."""
