"""cub's radix sort of (key, value) pairs: the library sort that
xla_sort.sort_arrays runs for a call with exactly one payload stream.

No Pallas kernel is replaced and no kernel is written by hand.  The JAX
package hands the payload to `jax.lax.sort` as a non-key operand
(simd_radix_sort_tpu/ops/xla_sort.py, `sort_arrays`); `torch.sort` takes one
tensor, so through it a payload needs an index and a gather.  `sort_pairs`
sorts the keys and one value stream together.  For a CUDA tensor it calls
cub's `DeviceRadixSort::SortPairs` or `SortPairsDescending` through the C
entries of csrc/sort_pairs.cu (built by ops/_build.py) or raises; for a CPU
tensor it runs `sort_pairs_plain`, `torch.sort` of the keys' carrier with
an index and a gather by it, which the card's tests also hold the library
call against.

Keys are integers of 1 to 8 bytes, signed or unsigned, as cub takes them;
xla_sort hands floating keys over as their signed carrier
(utils/transforms.to_sortable).  Values are any dtype of 1, 2, 4 or 8 bytes,
moved as bits.  The sort is stable in both directions.  The entries pass
cub a 32-bit `num_items`, so a call sorts at most MAX_ITEMS pairs.

cub runs one pass for each 8 key bits it is given.  `sort_pairs` gives it
only the bits in which the keys differ (`bit_window`): K8, the hand-written
kernel of csrc/key_bits.cu (`key_bits`; plain version `key_bits_plain`),
ORs every key XORed with the first into one word on the card, and the host
reads that word once; cub's temp storage, for the full width, is allocated
while the card reads the keys.  cub twiddles a key by XOR with a constant
(the sign bit of a signed key, and all bits when descending), which leaves
k ^ k[0] as it is, so a stable sort over the word's lowest to highest set
bit gives the full-width sort's order, ties included, keys of either sign
alike.  Where one pass costs less than that read (`window_floor`), the
sort keeps the whole key and reads nothing.

`LAUNCHES["sort_pairs"]` counts the library's sorts, one C call each, and
`LAUNCHES["key_bits"]` K8's calls.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..models import roofline
from ..utils import common, profiling, transforms
from . import _build

LAUNCHES = {"sort_pairs": 0, "key_bits": 0}

MAX_ITEMS = 2**31 - 1  # the entries' int num_items
# csrc/sort_pairs.cu's key codes
KEY_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
             torch.uint32: 4, torch.int32: 5, torch.uint64: 6, torch.int64: 7}
VALUE_WIDTHS = (1, 2, 4, 8)
SAMPLE = 4096  # csrc/key_bits.cu kSample: the keys of K8's sample
# One host read of K8's word: its two launches, the 8-byte copy into pinned
# memory and the wait, on an otherwise idle H100 (median of
# workloads/kernel_ab.host_read_timings; bench_out_h100/host_read.json).
HOST_READ_S = 76.0e-6
HBM_BYTES_PER_S = roofline.CHIPS["h100-sxm"].hbm_gbps * 1e9


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(keys: torch.Tensor, values: torch.Tensor) -> None:
    if keys.dtype not in KEY_CODES:
        raise TypeError(f"no pair sort of {keys.dtype} keys")
    if values.element_size() not in VALUE_WIDTHS:
        raise TypeError(f"no pair sort of {values.dtype} values")
    if keys.dim() != 1 or values.shape != keys.shape:
        raise ValueError("keys and values must be 1-D of one length")
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("keys and values must be contiguous")
    if keys.device != values.device:
        raise ValueError("keys and values must be on one device")
    if keys.numel() > MAX_ITEMS:
        raise ValueError(f"at most {MAX_ITEMS} pairs a call")


def passes(begin: int, end: int) -> int:
    """cub's 8-bit passes over the key bits [begin, end)."""
    return -(-(end - begin) // 8)


def _span(word: int) -> tuple[int, int]:
    """[lowest set bit, highest set bit + 1) of word; (0, 0) for 0."""
    return ((word & -word).bit_length() - 1, word.bit_length()) if word \
        else (0, 0)


def window(word: int, key_bytes: int) -> tuple[int, int]:
    """The key bits [begin, end) cub sorts keys of `key_bytes` bytes whose
    K8 word is `word` by: the bits in which the keys differ, or the whole
    key where they need every pass of it; (0, 0) when all keys are equal."""
    bits = _span(word)
    return (0, 8 * key_bytes) if passes(*bits) == key_bytes else bits


def _or_of(x: torch.Tensor) -> int:
    """The OR of a 1-D integer tensor's elements, as a Python int of the
    element's width (unsigned): halves ORed together, log2(n) steps."""
    while x.numel() > 1:
        half = x.numel() // 2
        y = x[:half] | x[half:2 * half]
        if x.numel() % 2:
            y[0] |= x[-1]
        x = y
    return int(x[0]) % (1 << (8 * x.element_size())) if x.numel() else 0


def _words(sample: int, word: int, device) -> torch.Tensor:
    return torch.tensor([w - (1 << 64) if w >> 63 else w
                         for w in (sample, word)], dtype=torch.int64,
                        device=device)


def key_bits_plain(keys: torch.Tensor) -> torch.Tensor:
    """K8's two words for n >= 1 keys, as int64 on the keys' device: [0] the
    OR of k[i] ^ k[0] over SAMPLE keys at rows j (n - 1) // (S - 1), j < S =
    min(n, SAMPLE); [1] the same OR over every key, or the sample's where its
    window already needs every pass of the key's width (a key's bits, zero
    above them)."""
    s = common.as_signed(keys)
    d = s ^ s[0]
    m = min(d.numel(), SAMPLE)
    rows = (torch.arange(m, device=keys.device) * (d.numel() - 1)
            // max(m - 1, 1))
    sample = _or_of(d.index_select(0, rows))
    if passes(*_span(sample)) == keys.element_size():
        return _words(sample, sample, keys.device)
    return _words(sample, _or_of(d), keys.device)


def key_bits(keys: torch.Tensor, host_word=None) -> torch.Tensor:
    """K8's two words for the contiguous 1-D `keys` (n >= 1), int64 on the
    keys' device (`key_bits_plain` says what they hold): two launches of
    csrc/key_bits.cu on a card, the plain version on the CPU.  On a card,
    `host_word` (a pinned int64 tensor of one element) also gets words[1],
    copied on the current stream behind the launches: the host waits for
    the stream before it reads it."""
    if keys.numel() < 1 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("key_bits takes contiguous 1-D keys, at least one")
    if not _build.on_cuda(keys):
        return key_bits_plain(keys)
    words = torch.empty(2, dtype=torch.int64, device=keys.device)
    _build.launch("srs_key_bits", keys.device, keys.data_ptr(),
                  keys.element_size(), keys.numel(), words.data_ptr(),
                  None if host_word is None else host_word.data_ptr())
    LAUNCHES["key_bits"] += 1
    return words


def window_floor(row_bytes: int) -> int:
    """The fewest pairs of `row_bytes` bytes (key and value) whose sort reads
    its bit window: the smallest n at which one of cub's passes, 2 n
    row_bytes bytes at HBM_BYTES_PER_S, outlasts one host read
    (HOST_READ_S).  A smaller sort keeps the whole key."""
    return math.floor(HOST_READ_S * HBM_BYTES_PER_S / (2 * row_bytes)) + 1


@functools.cache
def _pinned_word(device_index: int):
    """A word of pinned host memory for a card's reads, and a NumPy view of
    it, which the host reads without a torch op."""
    word = torch.empty(1, dtype=torch.int64, pin_memory=True)
    return word, word.numpy()


def _queue_read(keys: torch.Tensor) -> np.ndarray:
    """K8's word for `keys`, queued for the host: on a card, copied into
    pinned memory on the current stream, which the host must wait for
    (`_wait_read`)."""
    if keys.device.type != "cuda":
        return key_bits(keys)[1:].numpy()
    word, view = _pinned_word(keys.device.index)
    key_bits(keys, word)
    return view


def _wait_read(word: np.ndarray, device: torch.device) -> int:
    """The queued word, unsigned, once the card's stream has reached it."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return int(word[0]) % (1 << 64)


def bit_window(keys: torch.Tensor, values: torch.Tensor, meanwhile=None):
    """(the key bits [begin, end) the pair sort of n >= 1 (keys, values)
    runs over, what `meanwhile()` returns): `window` of K8's word where n
    reaches `window_floor`, else the whole key.  `meanwhile`, if given,
    runs once, after K8 and its word's copy are queued and before the host
    waits for them, so the card reads the keys while the host works.
    Counts the read (`host_syncs.xla.bits`, inside span `srs.xla.bits`),
    the passes cub is given (`xla.pairs_passes`) and a sort given fewer
    passes than its key's width (`xla.pairs_narrowed`)."""
    kb = keys.element_size()
    bits, work = (0, 8 * kb), meanwhile or (lambda: None)
    if keys.numel() >= window_floor(kb + values.element_size()):
        with profiling.span("srs.xla.bits"):
            profiling.count("host_syncs.xla.bits")
            word = _queue_read(keys)
            got = work()
            bits = window(_wait_read(word, keys.device), kb)
    else:
        got = work()
    p = passes(*bits)
    profiling.count("xla.pairs_passes", p)
    if p < kb:
        profiling.count("xla.pairs_narrowed")
    return bits, got


def sort_pairs_plain(keys: torch.Tensor, values: torch.Tensor,
                     descending: bool = False, bits=None):
    """A stable `torch.sort` of the keys' carrier, or of its bits
    [begin, end) = `bits` as cub's windowed sort takes them (an empty
    window keeps the input order), with its index, and the keys and values
    gathered by the index: the order cub's pair sort gives.  `bits` None:
    the whole key."""
    dt = common.np_dtype(keys.dtype)
    c = transforms.sortable_from_bits(keys, dt, not descending)
    nbits = 8 * dt.itemsize
    begin, end = (0, nbits) if bits is None else bits
    if end - begin == nbits:
        idx = torch.sort(c, stable=True).indices
    elif end == begin:
        idx = torch.arange(c.numel(), device=c.device)
    else:
        # the unsigned key cub sorts is the carrier with its sign bit
        # flipped; the bits above the window are masked off
        u = c ^ -(1 << (nbits - 1))
        idx = torch.sort((u >> begin) & ((1 << (end - begin)) - 1),
                         stable=True).indices
    return (common.as_signed(keys).index_select(0, idx).view(keys.dtype),
            common.as_signed(values).index_select(0, idx).view(values.dtype))


def sort_pairs(keys: torch.Tensor, values: torch.Tensor,
               descending: bool = False):
    """(keys, values) sorted by key, ascending or descending, each value
    beside its key and equal keys in their input order: new tensors, the
    inputs left as they are.  `keys` and `values` are contiguous 1-D
    tensors of one length on one device.  cub (or the plain version on the
    CPU) sorts by the key bits `bit_window` gives; all keys equal, the
    pairs are copied."""
    _check(keys, values)
    n = keys.numel()
    if not _build.on_cuda(keys):
        return sort_pairs_plain(keys, values, descending,
                                bit_window(keys, values)[0] if n else None)
    keys_out, values_out = torch.empty_like(keys), torch.empty_like(values)
    if n == 0:
        return keys_out, values_out
    kind = (KEY_CODES[keys.dtype], values.element_size(), int(descending))

    def temp_storage():
        """cub's temp storage for the full width, which holds any
        window's: made while K8 reads the keys."""
        nbytes = ctypes.c_size_t(0)
        _build.launch("srs_sort_pairs_temp_bytes", keys.device, *kind, n, 0,
                      8 * keys.element_size(), ctypes.byref(nbytes))
        return (torch.empty(max(nbytes.value, 1), dtype=torch.uint8,
                            device=keys.device), nbytes.value)

    (begin, end), (temp, temp_bytes) = bit_window(keys, values, temp_storage)
    if begin == end:
        keys_out.copy_(keys)
        values_out.copy_(values)
        return keys_out, values_out
    _build.launch("srs_sort_pairs", keys.device, *kind, keys.data_ptr(),
                  keys_out.data_ptr(), values.data_ptr(),
                  values_out.data_ptr(), n, begin, end, temp.data_ptr(),
                  temp_bytes)
    LAUNCHES["sort_pairs"] += 1
    return keys_out, values_out
