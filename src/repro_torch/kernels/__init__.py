"""Hand-written Hopper kernels of the port, one family per subpackage.

  xbar/    - greedy-crossbar contention scan (stage 2)
  netsim/  - admission-gated port replay and the fixed point (stage 4)
  islip/   - batched iSLIP matching (the cycle-level switch's scheduler)
  parser/  - protocol header field extraction (the switch's ingress)
  quant_pack/ - int8 payload quantize/dequantize (the MoE dispatch fabric)

Each family keeps the JAX package's triple: ``kernel.py`` binds the CUDA
kernel (sources in ``repro_torch/csrc/``, built by ``build.py`` at first
use), ``ref.py`` holds its plain PyTorch version, ``ops.py`` is the public
op, which launches the kernel for CUDA tensors and runs the plain version
for CPU tensors.
"""
