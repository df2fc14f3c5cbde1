"""Fixed-capacity lane compaction with no host read.

The role of the reference's ``_chunked`` / ``_compacted``
(swift_game_engine_tpu/render/rt.py:329-427): the set lanes of a mask of
``p`` lanes, gathered into ``cap`` slots so that a body runs on them alone.
The reference sizes its ``jnp.nonzero(m, size=cap, fill_value=p)`` on the
device and loops a ``while_loop`` until the mask is drained; here

  * ``compact(mask)`` gives ``Lanes``: ``idx`` (cap,) int64, the set
    lanes in ascending order, then the fill value ``p``; ``valid`` (cap,)
    bool; ``count``, a 0-d int32 tensor on the device (the set lanes in
    these slots). ``torch.nonzero_static`` gives the order, the
    reference's ``jnp.nonzero(m, size=cap, fill_value=p)``; on the card
    it reads nothing back (checked under
    ``torch.cuda.set_sync_debug_mode("error")``);
  * ``gather`` clamps the index, so a fill slot reads lane p - 1 (a body
    keeps such slots inactive by ``valid``), and ``scatter`` drops the fill
    slots;
  * ``chunks(mask, cap)`` gives every chunk of ``cap`` slots, ceil(p / cap)
    of them whatever the mask holds: the reference's data-dependent trip
    count becomes its fixed bound. The frame compacts with ``compact``:
    one chunk of ``cap = p``, the lane universe, so no set lane is dropped;
  * ``packets(mask, block)`` compacts by whole runs of ``block`` lanes, the
    reference's ``_chunked_packets`` (rt.py:493-552): each run holding a
    set lane keeps its lanes at their offsets, the run's unset lanes are
    fill slots.

Nothing reads the count back, so a frame built on it can be captured as
one CUDA graph; its bodies run at their capacity, and the kernels that take
``count`` (K4, K6) skip the lanes past it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Lanes(NamedTuple):
    """One chunk of compacted lanes of a ``p``-lane mask."""

    idx: torch.Tensor     # (cap,) int64: set lanes ascending, then p
    valid: torch.Tensor   # (cap,) bool: idx < p
    count: torch.Tensor   # () int32: the set lanes in this chunk
    p: int                # the mask's lanes

    @property
    def safe(self) -> torch.Tensor:
        """The index clamped into the lanes: fill slots read lane p - 1."""
        return self.idx.clamp(max=max(self.p - 1, 0))


def chunks(mask, cap=None) -> list[Lanes]:
    """Every chunk of ``cap`` (default: all ``p``) slots of the set lanes of
    the (p,) bool ``mask``, in ascending lane order: chunk i holds set
    lanes i*cap .. (i+1)*cap - 1 of the order; ceil(p / cap) chunks."""
    p = mask.shape[0]
    cap = max(p, 1) if cap is None else int(cap)
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")
    n = -(-max(p, 1) // cap)
    idx = torch.nonzero_static(mask, size=n * cap, fill_value=p).squeeze(1)
    total = mask.sum(dtype=torch.int32)
    return [Lanes(idx=c, valid=c < p, count=torch.clamp(total - i * cap, 0,
                                                        cap), p=p)
            for i, c in enumerate(idx.split(cap))]


def compact(mask) -> Lanes:
    """The set lanes of the (p,) bool ``mask`` in one chunk of ``p``
    slots, the lane universe: no set lane is ever dropped."""
    return chunks(mask)[0]


def packets(mask, block: int) -> Lanes:
    """The set lanes of the (p,) bool ``mask`` by packets, runs of
    ``block`` consecutive lanes: every packet holding a set lane, in lane
    order, takes ``block`` slots, a set lane at its offset in the packet
    and the packet's unset lanes as fill; the slots past the live packets
    are fill too (capacity p). ``count`` is the slots the live packets
    take, so a kernel that skips the lanes past it still reads every set
    lane. A mask of at most ``block`` lanes, or of lanes that ``block``
    does not divide, is compacted by lanes (``compact``), as the reference
    falls back."""
    p = mask.shape[0]
    if p <= block or p % block:
        return compact(mask)
    nb = p // block
    pk = mask.reshape(nb, block)
    live = pk.any(1)
    pid = torch.nonzero_static(live, size=nb, fill_value=nb).squeeze(1)
    safe = pid.clamp(max=nb - 1)
    lanes = safe[:, None] * block + torch.arange(block, device=mask.device)
    valid = (pk[safe] & (pid < nb)[:, None]).reshape(-1)
    return Lanes(idx=torch.where(valid, lanes.reshape(-1), p), valid=valid,
                 count=live.sum(dtype=torch.int32) * block, p=p)


def gather(x, lanes: Lanes):
    """``x`` (p, ...) at the compacted lanes; fill slots read lane p - 1."""
    return x[lanes.safe]


def scatter(base, lanes: Lanes, values):
    """``base`` (p, ...) with the compacted lanes set to ``values`` (cap,
    ...); the fill slots are dropped. Returns a new tensor."""
    out = torch.cat([base, base[:1]])      # row p: where fill slots land
    out[lanes.idx] = values.to(out.dtype)
    return out[:-1]
