"""Comm-layer message protocols — SPAC's protocol customisation on the
cross-pod link.

The port's counterpart of the JAX package's ``comm/protocols.py``.  The
paper strips general-purpose header overhead per workload; here the
cross-pod gradient synchronisation protocol is customisable the same way:

  * ``bf16``  — baseline: the mean of the pods' gradients in their dtype
                (the reference's ``pmean`` over ``pod``)
  * ``int8``  — compressed protocol: per-128-group int8 payload + float32
                scales (``kernels.quant_pack``: the hand-written kernels on
                a card), exchanged and averaged after dequantising (~3.5x
                fewer cross-pod bytes than a bf16 all-reduce)

``wrap_grad_fn_with_pod_protocol`` runs the gradient function once per pod
shard of a ``launch.mesh.Mesh`` (the batch split over ``pod``, each pod's
call on the device of its first shard), then exchanges the gradients with
the chosen payload and averages loss and metrics over the pods, as the
reference's ``shard_map`` manual over ``pod`` does.  The reference refuses
where its JAX lacks partial-manual ``shard_map``; the port has no such
limit.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.kernels.quant_pack import ops as qops
from repro_torch.train.optimizer import tree_leaves, tree_map

__all__ = ["compressed_mean", "wrap_grad_fn_with_pod_protocol"]

GROUP = qops.GROUP


def _leaf_compressed_mean(gs: List[torch.Tensor]) -> torch.Tensor:
    """The pods' copies of one leaf (each on its pod's device) -> the mean
    of their int8 payloads, dequantised, on the first pod's device."""
    home = gs[0].device
    shape, size = gs[0].shape, gs[0].numel()
    pad = (-size) % GROUP
    deq = []
    for g in gs:
        flat = torch.nn.functional.pad(g.reshape(-1).to(torch.float32), (0, pad))
        q, s = qops.quantize(flat.reshape(-1, GROUP))     # int8 on the wire
        deq.append(qops.dequantize(q.to(home), s.to(home), torch.float32))
    mean = torch.stack(deq).mean(0)
    return mean.reshape(-1)[:size].reshape(shape).to(gs[0].dtype)


def compressed_mean(grads_per_pod: List):
    """The pods' gradient trees (one per pod) -> their int8-payload mean."""
    return tree_map(lambda *gs: _leaf_compressed_mean(list(gs)), *grads_per_pod)


def _pmean(vals: List[torch.Tensor]) -> torch.Tensor:
    home = vals[0].device
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v.to(home)
    return acc / len(vals)


def wrap_grad_fn_with_pod_protocol(grad_fn: Callable, mesh, *, payload: str = "int8"):
    """grad_fn(params, batch) -> ((loss, metrics), grads), pod-synchronised
    with the chosen payload protocol over ``mesh``'s ``pod`` axis."""
    if payload not in ("int8", "bf16"):
        raise ValueError(f"unknown pod payload {payload!r}; use 'int8' or 'bf16'")
    if "pod" not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no 'pod' axis")
    npod = mesh.shape["pod"]
    pod_at = mesh.axis_names.index("pod")
    devices = []
    for p in range(npod):
        coords = [0] * len(mesh.axis_names)
        coords[pod_at] = p
        devices.append(mesh.devices[mesh.shard(coords)])

    def wrapped(params, batch):
        b = next(iter(batch.values())).shape[0]
        if b % npod:
            raise ValueError(f"batch {b} does not split over {npod} pods")
        rows = b // npod
        outs = []
        for p, dev in enumerate(devices):
            pp = tree_map(lambda t: t.to(dev), params)
            pb = {k: v[p * rows:(p + 1) * rows].to(dev) for k, v in batch.items()}
            outs.append(grad_fn(pp, pb))              # pod-local gradients
        grads = [g for _, g in outs]
        if payload == "int8":
            g = compressed_mean(grads)
        else:
            g = tree_map(lambda *gs: _pmean(list(gs)), *grads)
        home = tree_leaves(params)[0].device
        loss = _pmean([l for (l, _), _ in outs]).to(home)
        metrics = {k: _pmean([m[k] for (_, m), _ in outs]).to(home)
                   for k in outs[0][0][1]}
        g = tree_map(lambda t, p: t.to(p.device), g, params)
        return (loss, metrics), g

    return wrapped
