"""Host-side helpers: metrics, logging, skeleton overlays."""
