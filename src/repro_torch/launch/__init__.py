"""Launch-layer constants of the port; so far only the analytic fabric
model's hardware dict (``roofline.TPU_V5E``)."""
