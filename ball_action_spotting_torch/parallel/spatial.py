"""Spatial partitioning ("sp"): the frame height cut into bands over the
model axis of a device grid, each band on its own device (the port's
counterpart of the JAX package's ``spatial_frames_sharding``, under which
GSPMD partitions every conv along the height and inserts the halo
exchanges and the cross-shard sums).

A ``Bands`` value is one tensor cut along its height axis: its per-band
tensors, their devices, the global row cuts (band i holds rows
``[cuts[i], cuts[i + 1])``, possibly none) and so the global height. The
model's modules take a ``Bands`` where they take a tensor, and the bands
advance through the network layer by layer, in lockstep, through three
primitives:

- ``window(bands, i, lo, hi)``: rows ``[lo, hi)`` of the global tensor on
  band i's device, from whichever bands hold them, with zeros outside
  ``[0, H)``: the halo exchange. ``row_op`` runs an op of kernel k, stride
  s and top pad t over it: output rows ``[a, b)`` need input rows
  ``[a·s − t, (b−1)·s − t + k)``, and each layer's output is cut anew by
  ``balanced_cuts`` (balanced shares of its rows, as ``process_slice``
  gives them, the cut ``parallel/mesh.py::spatial_bands`` gives the
  input), so a band may be empty and a window may reach past a
  neighbour.
  ``halo_op`` runs an op with its own SAME padding on a window clipped to
  ``[0, H)`` and crops the halo rows of its output.
- ``band_sum(bands, dims)``: each band's float32 sums over ``dims``, added
  in band order on the first band's device and copied back to each band:
  the SE means, GeM's and the train-mode BN statistics' sums. The order is
  fixed, so runs are deterministic. ``band_max(bands)`` takes the largest
  |element| of every band the same way (the int8 convs' activation
  scale), exact in any order.

Every copy is a differentiable ``.to(device, non_blocking=True)``, issued
before the op that reads it, so gradients flow back to every band. A
module's weights live on one device and each band's op uses them through
``.to(band device)`` (a no-op on the weights' own device), so their
gradients gather there. ``COUNTS`` adds up the rows that windows take from
other bands (bytes, counted from shapes) and the cross-band sums.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ball_action_spotting_torch.parallel.multihost import process_slice


@dataclasses.dataclass
class BandCounts:
    """Halo traffic since the last ``reset``: bytes of rows that windows
    copied from another band, and the cross-band sums and maxima taken."""

    halo_bytes: int = 0
    halo_copies: int = 0
    band_sums: int = 0
    band_maxes: int = 0

    def reset(self) -> None:
        self.halo_bytes = self.halo_copies = self.band_sums = self.band_maxes = 0


COUNTS = BandCounts()


def balanced_cuts(rows: int, n: int) -> tuple[int, ...]:
    """The n + 1 cuts of ``rows`` rows into n balanced contiguous bands
    (``process_slice``'s shares; bands past ``rows`` are empty)."""
    return tuple(process_slice(rows, i, n).start for i in range(n)) + (rows,)


@dataclasses.dataclass(frozen=True)
class Bands:
    """One tensor cut along axis ``axis`` into ``len(devices)`` bands."""

    parts: tuple[torch.Tensor, ...]
    devices: tuple[torch.device, ...]
    cuts: tuple[int, ...]
    axis: int

    def __post_init__(self):
        if not len(self.parts) == len(self.devices) == len(self.cuts) - 1:
            raise ValueError(f"{len(self.parts)} parts, {len(self.devices)} devices and "
                             f"{len(self.cuts)} cuts do not make bands")
        for i, part in enumerate(self.parts):
            lo, hi = self.rows(i)
            if part.shape[self.axis] != hi - lo:
                raise ValueError(f"band {i} holds {part.shape[self.axis]} rows, its cut "
                                 f"{hi - lo}")

    @property
    def height(self) -> int:
        return self.cuts[-1]

    @property
    def shape(self) -> tuple[int, ...]:
        """The global shape: a band's, with the global height."""
        shape = list(self.parts[0].shape)
        shape[self.axis] = self.height
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def rows(self, i: int) -> tuple[int, int]:
        return self.cuts[i], self.cuts[i + 1]

    def map(self, fn: Callable, axis: int | None = None) -> "Bands":
        """``fn`` on every band (empty ones included), which keeps the rows
        and moves the height to ``axis`` (default: where it was)."""
        return Bands(tuple(fn(p) for p in self.parts), self.devices, self.cuts,
                     self.axis if axis is None else axis)

    def map_with(self, values: Sequence, fn: Callable) -> "Bands":
        """``fn(band, value)`` on every band with its own of ``values`` (one
        per band, such as ``band_sum``'s totals)."""
        return Bands(tuple(fn(p, v) for p, v in zip(self.parts, values)), self.devices,
                     self.cuts, self.axis)

    def permute(self, *dims: int) -> "Bands":
        return self.map(lambda t: t.permute(*dims), axis=dims.index(self.axis))

    def moved(self, devices: Sequence[torch.device]) -> "Bands":
        """The same bands on ``devices``, band by band."""
        devices = tuple(devices)
        return Bands(tuple(p.to(d, non_blocking=True) for p, d in zip(self.parts, devices)),
                     devices, self.cuts, self.axis)

    def __add__(self, other: "Bands") -> "Bands":
        if not isinstance(other, Bands) or other.cuts != self.cuts:
            raise ValueError("bands add only to bands of the same cuts")
        return Bands(tuple(a + b for a, b in zip(self.parts, other.parts)), self.devices,
                     self.cuts, self.axis)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first band's)."""
        device = self.devices[0] if device is None else device
        return torch.cat([p.to(device) for p in self.parts], dim=self.axis)


def device_of(x: torch.Tensor | Bands) -> torch.device:
    """The device of a tensor, or of the first of its bands."""
    return x.devices[0] if isinstance(x, Bands) else x.device


def bands_of(x: torch.Tensor, devices: Sequence, cuts: Sequence[int], axis: int) -> Bands:
    """``x`` cut along ``axis`` at ``cuts`` (``spatial_bands``'), each band
    copied straight to its device."""
    devices, cuts = tuple(torch.device(d) for d in devices), tuple(cuts)
    parts = tuple(x.narrow(axis, cuts[i], cuts[i + 1] - cuts[i]).to(d, non_blocking=True)
                  for i, d in enumerate(devices))
    return Bands(parts, devices, cuts, axis)


def cat_bands(pieces: Sequence[Bands], dim: int) -> Bands:
    """Bands of the same cuts and devices concatenated along ``dim`` (not
    the height axis), band by band."""
    if len(pieces) == 1:
        return pieces[0]
    first = pieces[0]
    parts = tuple(torch.cat([b.parts[i] for b in pieces], dim=dim)
                  for i in range(len(first.parts)))
    return Bands(parts, first.devices, first.cuts, first.axis)


def window(bands: Bands, i: int, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the global tensor on band i's device, taken from
    whichever bands hold them, with zero rows outside ``[0, H)``. Rows of
    band i itself are a view; the others are copied. The zero rows take
    the band's memory format, so that a channels-last band's window stays
    channels-last (a mixed concatenation comes out NCHW, which sends a
    depthwise conv to a slow native kernel and the others through layout
    conversions)."""
    dev, axis = bands.devices[i], bands.axis
    pieces = []
    template = bands.parts[i]
    channels_last = template.dim() == 4 and template.stride(1) == 1 and template.stride(3) != 1

    def zeros(rows: int) -> torch.Tensor:
        shape = list(template.shape)
        shape[axis] = rows
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        return torch.zeros(shape, dtype=template.dtype, device=dev).contiguous(memory_format=fmt)

    if lo < 0:
        pieces.append(zeros(min(hi, 0) - lo))
    for j, part in enumerate(bands.parts):
        a, b = bands.rows(j)
        s, e = max(lo, a), min(hi, b)
        if s < e:
            piece = part.narrow(axis, s - a, e - s)
            if j != i:
                COUNTS.halo_bytes += piece.numel() * piece.element_size()
                COUNTS.halo_copies += 1
                piece = piece.to(dev, non_blocking=True)
            pieces.append(piece)
    if hi > bands.height:
        pieces.append(zeros(hi - max(lo, bands.height)))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=axis)


def _fill_empty(outs: list, bands: Bands, cuts: tuple[int, ...], axis: int) -> Bands:
    """Bands from per-band outputs, an empty band's None replaced by a
    zero-row tensor of the others' shape on its device."""
    template = next(o for o in outs if o is not None)
    parts = []
    for o, dev in zip(outs, bands.devices):
        if o is None:
            shape = list(template.shape)
            shape[axis] = 0
            o = template.new_empty(shape, device=dev)
        parts.append(o)
    return Bands(tuple(parts), bands.devices, cuts, axis)


def row_op(bands: Bands, kernel: int, stride: int, top: int, rows_out: int,
           fn: Callable[[torch.Tensor], torch.Tensor]) -> Bands:
    """An op of kernel ``kernel``, stride ``stride`` and top pad ``top``
    along the height, which ``fn`` runs with no height padding on each
    band's window: output rows ``[a, b)`` (``rows_out`` rows in balanced
    shares over the same devices, whatever the input's cuts) read
    input rows ``[a·s − t, (b−1)·s − t + k)``. Every window is assembled,
    its copies issued, before ``fn`` runs on any; an empty output band runs
    nothing."""
    cuts = balanced_cuts(rows_out, len(bands.devices))
    wins = []
    for i in range(len(bands.devices)):
        a, b = cuts[i], cuts[i + 1]
        wins.append(window(bands, i, a * stride - top, (b - 1) * stride - top + kernel)
                    if b > a else None)
    return _fill_empty([None if w is None else fn(w) for w in wins], bands, cuts,
                       bands.axis)


def halo_op(bands: Bands, halo: int, fn: Callable[[torch.Tensor], torch.Tensor]) -> Bands:
    """A stride-1 op that pads the height itself (SAME zeros, reach
    ``halo``): ``fn`` runs on each band's window ``[a − halo, b + halo)``
    clipped to ``[0, H)``, so that its own zeros stand at the global edges,
    and the halo rows of its output are cropped. Empty bands run nothing."""
    h, axis = bands.height, bands.axis
    wins = []
    for i in range(len(bands.devices)):
        a, b = bands.rows(i)
        lo, hi = max(a - halo, 0), min(b + halo, h)
        wins.append((window(bands, i, lo, hi), a - lo, b - a) if b > a else None)
    outs = [None if w is None else fn(w[0]).narrow(axis, w[1], w[2]) for w in wins]
    return _fill_empty(outs, bands, bands.cuts, axis)


def add_in_order(partials: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``partials`` (one per band) added in band order on ``device``."""
    COUNTS.band_sums += 1
    total = partials[0].to(device, non_blocking=True)
    for p in partials[1:]:
        total = total + p.to(device, non_blocking=True)
    return total


def band_sum(bands: Bands, dims: Sequence[int]) -> list[torch.Tensor]:
    """Float32 sums of each band over ``dims``, added in band order on the
    first band's device, then copied back: one total per band, on its
    device. Differentiable: each band's gradient is the total's."""
    partials = [p.sum(tuple(dims), dtype=torch.float32) for p in bands.parts]
    total = add_in_order(partials, bands.devices[0])
    return [total.to(d, non_blocking=True) for d in bands.devices]


def band_max(bands: Bands) -> torch.Tensor:
    """The largest |element| over every band: each non-empty band's max,
    taken in band order on the first band's device (0-dim, in the bands'
    dtype)."""
    COUNTS.band_maxes += 1
    partials = [torch.linalg.vector_norm(p, float("inf")) for p in bands.parts if p.numel()]
    total = partials[0].to(bands.devices[0], non_blocking=True)
    for p in partials[1:]:
        total = torch.maximum(total, p.to(bands.devices[0], non_blocking=True))
    return total
