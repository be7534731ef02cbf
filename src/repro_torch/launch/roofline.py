"""The hardware dict the comm domain's analytic fabric model prices with.

The port's copy of ``TPU_V5E`` from the JAX package's
``launch/roofline.py``: ``CommDSEProblem`` defaults to it
(``comm/dse_comm.py``), so the port's reports price candidates exactly as
the reference's do.  These are a TPU v5e chip's published peaks, the
analytic model's target hardware; they are not numbers of the card the
port runs on.  A dict for the H100 is later work (ROADMAP).  The rest of
the reference module (HLO collective parsing, dry-run roofline terms) has
no counterpart in the port.
"""

TPU_V5E = {
    "peak_flops_bf16": 197e12,   # per chip
    "hbm_gbps": 819e9,           # bytes/s
    "ici_link_gbps": 50e9,       # bytes/s per link
}
