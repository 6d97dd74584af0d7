"""Parameters, batches and clustering state between the JAX package and
the port.

The reference's trees are nested dicts of arrays (numpy, or anything
``numpy.asarray`` accepts); the port's are nested dicts of tensors in the
same layouts, so conversion is a leaf-wise copy and changes no value. The
reference's device clustering state travels as its ``DeviceClusters.arrays()``
dict of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """Nested dict of arrays -> nested dict of tensors on ``device``
    (dtypes kept; a bfloat16 array, which numpy holds as ``ml_dtypes``'
    type, travels as its 16-bit patterns)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16; hand over the widened values
        t = t.to(torch.float32)
    return t.numpy()


def device_clusters(arrays, tau: float, device="cpu"):
    """The port's ``DeviceClusters`` from the reference's
    ``DeviceClusters.arrays()`` (numpy ``parent`` int32, ``live`` bool,
    ``rep`` float32), so both packages can start from one clustering
    state. The values are copied unchanged."""
    from repro_torch.core.device_clustering import DeviceClusters
    return DeviceClusters.from_arrays(tau, np.asarray(arrays["parent"]),
                                      np.asarray(arrays["live"]),
                                      np.asarray(arrays["rep"]), device=device)
