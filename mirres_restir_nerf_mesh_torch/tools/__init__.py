"""Dataset tools for a user's capture: ``colmap2nerf`` and ``remove_bg``."""
