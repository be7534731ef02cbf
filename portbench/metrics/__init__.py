"""Per-layer metric readers, one file per metric, found by name
(``spec.metric_reader``): each defines ``read(r) -> float | None`` over a
``_kernels.Reading`` and returns None where its kernels did not run."""
