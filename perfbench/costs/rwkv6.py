"""FLOPs of RWKV-6 "Finch"'s prefill and train steps, and the operations
and bytes of its two scan kernels, from a configuration's ``model`` dict.

A product of an (m, k) by a (k, n) matrix is 2 m k n operations.  Model
FLOPs count every weight matrix a token passes through (r, k, v, g and
the output of the time mix, both LoRAs' two matrices, the channel mix's
key, value and receptance, the head) and the WKV recurrence, 5 hd^2 + 5
hd operations a token and head (:func:`scan_fwd_cost`).  A train step is
the forward and twice the forward for the backward; the recompute of
remat is not counted.

The scans' counts are those of the program's ``rwkv6_scan_cost`` and
``rwkv6_scan_bwd_cost``, copied here as the benchmark's own yardstick,
with the names of the kernels whose device time they are read against."""
from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

# the kernels of one scan forward (one launch of each per call; the state
# pass only where the sequence spans more than one chunk) and of one
# backward, and the kernel each counts its calls by
FWD_KERNELS, FWD_COUNTED = ("wkv_state", "wkv_out"), "wkv_out"
BWD_KERNELS, BWD_COUNTED = ("wkv_bwd_state", "wkv_bwd", "wkv_bwd_du"), \
    "wkv_bwd_du"


def heads(a: dict) -> Tuple[int, int]:
    """(H, hd) of the model's WKV heads."""
    hd = a["rwkv_head_size"]
    return a["d_model"] // hd, hd


def matmul_params(a: dict) -> int:
    """Weights a token multiplies through in one forward, the head
    included."""
    c, f = a["d_model"], a["d_ff"]
    lora = 2 * 5 * c * a["rwkv_mix_lora"] + 2 * c * a["rwkv_decay_lora"]
    layer = 5 * c * c + lora + 2 * c * f + c * c
    return a["n_layers"] * layer + c * a["vocab"]


def scan_fwd_cost(b: int, t: int, h: int, hd: int, itemsize: int) -> tuple:
    """(operations, bytes) of one WKV forward: per step and head 2 hd^2
    for r.S, 3 hd^2 for S's update, 5 hd for the bonus; r, k, v, w read
    once, u read and y written once."""
    ops = b * t * h * (5 * hd * hd + 5 * hd)
    nbytes = 5 * b * t * h * hd * itemsize + h * hd * 4
    return ops, nbytes


def scan_bwd_cost(b: int, t: int, h: int, hd: int, itemsize: int) -> tuple:
    """(operations, bytes) of one WKV backward: per step and head 3 hd^2
    each to step S forward and G back, 2 hd^2 each for dr, dk, dv and dw,
    16 hd for the bonus's terms and du; r, k, v, w, dy read once, dr, dk,
    dv, dw written once, u read and du written once."""
    ops = b * t * h * (14 * hd * hd + 16 * hd)
    nbytes = 9 * b * t * h * hd * itemsize + 2 * h * hd * 4
    return ops, nbytes


def scan_flops(a: dict, b: int, s: int) -> int:
    h, hd = heads(a)
    return a["n_layers"] * scan_fwd_cost(b, s, h, hd, 4)[0]


def prefill_flops(a: dict, b: int, s: int) -> int:
    return 2 * matmul_params(a) * b * s + scan_flops(a, b, s)


def train_flops(a: dict, b: int, s: int) -> int:
    return 3 * prefill_flops(a, b, s)


def kernel_name(name: str) -> str:
    """A device operation's function name, without its return type,
    namespaces, template arguments and parameters (``void (anonymous
    namespace)::wkv_out<float, 64>(float const*, ...)`` -> ``wkv_out``);
    a name with neither is returned whole."""
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", re.sub(r"^void\s+", "", name))
    return m.group(1) if m else name


def launches_and_seconds(kernels: Dict[str, Tuple[int, float]],
                         names: Iterable[str], counted: str
                         ) -> Tuple[int, float]:
    """(launches of `counted`, device seconds of every kernel in `names`)
    in a trace's {name: (launches, seconds)}, names matched whole."""
    names = set(names)
    launches, seconds = 0, 0.0
    for name, (n, t) in kernels.items():
        base = kernel_name(name)
        if base in names:
            seconds += t
            if base == counted:
                launches += n
    return launches, seconds
