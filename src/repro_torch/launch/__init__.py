"""Launch layer of the port: the analytic fabric model's hardware dict
(``roofline.TPU_V5E``) and the token-serving driver (``serve``)."""
