"""CommOp: the NQE analogue — a fixed-schema communication descriptor.

NetKernel carries socket *semantics* between guest and NSM as 32-byte
NetKernel Queue Elements (NQEs), keeping bulk data out of the control path.
Here, the semantics of a collective (verb, mesh axis, tenant, payload size)
are carried as ``CommOp`` records with an exact 32-byte packed binary
encoding. CoreEngine routes, accounts and rate-limits in terms of CommOps;
bulk tensors stay in device memory (the "hugepages") and never enter this
path.

Layout (32 bytes, little-endian), mirroring Figure 3 of the paper:

    1B  verb        (op type)
    1B  tenant_id   (VM ID)
    1B  axis_code   (queue-set ID analog: which mesh axis/axes)
    1B  flags       (reserved: bit0 = gradient, bit1 = serving path)
    4B  tag         (VM socket ID analog: caller-chosen correlation id)
    8B  op_data     (verb-specific: e.g. permutation id, chunk index)
    8B  size_bytes  (data pointer+size analog: payload bytes in HBM)
    4B  shape_crc   (crc32 of shape/dtype string: semantic checksum)
    4B  reserved
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

VERBS = (
    "psum",            # all-reduce
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "ppermute",        # neighbor exchange (rings, pipelines)
    "broadcast",
    "shm_move",        # colocated fast path: sharding-compatible move/elision
)
VERB_CODE = {v: i for i, v in enumerate(VERBS)}

# Mesh axes are encoded as a bitmask so multi-axis ops ("pod"+"data") fit 1B.
AXIS_BITS = {"pod": 1, "data": 2, "model": 4, "stage": 8}
_AXIS_MASK = 0
for _b in AXIS_BITS.values():
    _AXIS_MASK |= _b
_STRUCT = struct.Struct("<BBBBIQQII")
NQE_SIZE = _STRUCT.size
assert NQE_SIZE == 32, NQE_SIZE

FLAG_GRADIENT = 1
FLAG_SERVING = 2


def _axis_code(axes: Tuple[str, ...]) -> int:
    code = 0
    for a in axes:
        try:
            code |= AXIS_BITS[a]
        except KeyError:
            raise ValueError(f"unknown mesh axis {a!r}") from None
    return code


def _axes_from_code(code: int) -> Tuple[str, ...]:
    return tuple(a for a, b in AXIS_BITS.items() if code & b)


@dataclass(frozen=True)
class CommOp:
    """One communication intent. Hashable, fixed-schema, 32-byte packable."""

    verb: str
    axes: Tuple[str, ...]
    tenant_id: int = 0
    tag: int = 0
    op_data: int = 0
    size_bytes: int = 0
    shape_desc: str = ""        # e.g. "bf16[256,4096,3072]"
    flags: int = 0
    # carried wire checksum for ops decoded without their shape_desc: a
    # forwarder's unpack() -> pack() must not replace the original
    # shape_crc with crc32("") and break verification downstream
    wire_crc: Optional[int] = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.verb not in VERB_CODE:
            raise ValueError(f"unknown verb {self.verb!r}")
        if not (0 <= self.tenant_id < 256):
            raise ValueError("tenant_id must fit in 1 byte")
        object.__setattr__(self, "axes", tuple(self.axes))

    # --- 32-byte wire format (the NQE) ---------------------------------
    def pack(self) -> bytes:
        crc = zlib.crc32(self.shape_desc.encode()) & 0xFFFFFFFF \
            if self.shape_desc or self.wire_crc is None else self.wire_crc
        return _STRUCT.pack(
            VERB_CODE[self.verb],
            self.tenant_id,
            _axis_code(self.axes),
            self.flags & 0xFF,
            self.tag & 0xFFFFFFFF,
            self.op_data & 0xFFFFFFFFFFFFFFFF,
            self.size_bytes & 0xFFFFFFFFFFFFFFFF,
            crc,
            0,
        )

    @classmethod
    def unpack(cls, raw: bytes,
               expect_shape: Optional[str] = None) -> "CommOp":
        """Decode a 32-byte NQE. Corrupt records are rejected, not guessed
        at: an out-of-range verb code or unknown axis bit raises ValueError,
        and ``expect_shape`` (the receiver's view of the payload) is checked
        against the carried shape_crc — the semantic checksum that catches a
        descriptor pointing at the wrong tensor."""
        if len(raw) != NQE_SIZE:
            raise ValueError(f"NQE must be {NQE_SIZE} bytes, got {len(raw)}")
        (verb, tenant, axis_code, flags, tag, op_data, size_bytes,
         crc, _rsvd) = _STRUCT.unpack(raw)
        if verb >= len(VERBS):
            raise ValueError(f"invalid verb code {verb}")
        if axis_code & ~_AXIS_MASK:
            raise ValueError(f"unknown axis bits 0x{axis_code:02x}")
        if expect_shape is not None and \
                zlib.crc32(expect_shape.encode()) & 0xFFFFFFFF != crc:
            raise ValueError(
                f"shape_crc mismatch: NQE carries 0x{crc:08x}, "
                f"expected shape {expect_shape!r}")
        return cls(
            verb=VERBS[verb],
            axes=_axes_from_code(axis_code),
            tenant_id=tenant,
            tag=tag,
            op_data=op_data,
            size_bytes=size_bytes,
            flags=flags,
            shape_desc=expect_shape or "",
            wire_crc=crc,
        )

    def matches(self, other: "CommOp") -> bool:
        """Wire-level equivalence (shape_desc only participates via crc,
        which is excluded here: bytes 24:28 of the layout)."""
        return self.pack()[:24] == other.pack()[:24]


def describe(x) -> str:
    """Shape descriptor string for a tensor (or any ``.dtype``/``.shape``
    object), with the reference's dtype names: ``bfloat16[3,4]``, not
    ``torch.bfloat16[3,4]`` — the string feeds ``shape_crc``, so the packed
    NQE of one op is the same in both packages."""
    try:
        dtype = str(x.dtype).removeprefix("torch.")
        return f"{dtype}[{','.join(map(str, x.shape))}]"
    except AttributeError:
        return str(type(x).__name__)


def payload_bytes(x) -> int:
    """Bytes of the payload in device memory: ``numel * element_size`` for
    a tensor; for a duck-typed payload (``control/sim.py``'s ``_Payload``),
    its shape times its numpy dtype's item size; 0 for anything else."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    try:
        n = 1
        for d in x.shape:
            n *= int(d)
        return n * np.dtype(x.dtype).itemsize
    except (AttributeError, TypeError):
        return 0
