"""Device and dtype policy of the port.

Every entry point takes a ``device`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU, as the tests do.
There is no silent CPU fallback - without a card torch raises at the
first allocation.  Config dtypes are strings (``"bfloat16"``), mapped
here to torch dtypes.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; anything else is taken as given."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a config string (``"bfloat16"``) or a dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; "
                         f"known: {sorted(_DTYPES)}") from None
