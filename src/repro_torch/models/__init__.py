"""Vision models served by the port (the ViT family)."""
