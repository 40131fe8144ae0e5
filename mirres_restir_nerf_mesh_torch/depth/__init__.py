"""Monocular depth for dense-depth supervision: the DPT-Hybrid net
(``dpt.py``) and the extraction CLI (``extract_depth.py``)."""
