"""The user's tools: ``colmap2nerf`` and ``remove_bg`` for a capture,
``downscale`` for its images, ``render_turntable`` and ``live_viewer`` for a
trained workspace."""
