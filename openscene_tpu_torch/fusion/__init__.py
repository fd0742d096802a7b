"""Multi-view feature fusion (``openscene_tpu.fusion``'s port)."""
