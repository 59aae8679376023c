"""Render path (torch): ray casting, configuration, pose modes, images."""
