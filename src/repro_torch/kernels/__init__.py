"""Hand-written Hopper kernels of the port, one family per subpackage.

  xbar/    - greedy-crossbar contention scan (stage 2)
  netsim/  - admission-gated port replay and the fixed point (stage 4)
  ring_scan/ - the finite-VOQ ring scan (stage 4 with use_kernel="off")
  islip/   - batched iSLIP matching (the eager loop's scheduler step)
  switch_loop/ - the cycle-level switch, every cycle in one launch
  parser/  - protocol header field extraction (the switch's ingress)
  quant_pack/ - int8 payload quantize/dequantize (the MoE dispatch fabric)
  flash_attention/ - causal GQA attention, online softmax (the prefill)
  ssd/     - Mamba-2 SSD chunked scan (the SSM layers' prefill)
  mamba_glue/ - the Mamba-2 mixer's conv, gates and norm around the scan

Each family keeps the JAX package's triple: ``kernel.py`` binds the CUDA
kernel (sources in ``repro_torch/csrc/``, built by ``build.py`` at first
use), ``ref.py`` holds its plain PyTorch version, ``ops.py`` is the public
op, which launches the kernel for CUDA tensors and runs the plain version
for CPU tensors.
"""
