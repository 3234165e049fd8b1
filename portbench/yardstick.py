"""The benchmark's arithmetic: the window, the device trace's busy
union and per-kernel sums (frozen copies of the port's
tools/profile_prove.py _busy_ms and device_ms_by_kernel), the prover's
phases on the profiler's clock, and the least time of the LDE from the
cell's shapes and the card's published peaks.
"""

# -- the card's peaks -------------------------------------------------------------
# HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds an SM issues a clock on Hopper
MADS_PER_CLOCK_PER_SM = 64
# one Fp252 product as 32-bit multiply-adds: 8 x 8 limb products and the
# Montgomery reduction's 8 x 8 (the yardstick chip_smoke.py takes)
MADS_PER_FP252_PRODUCT = 128
FP252_BYTES = 32


# -- the window -------------------------------------------------------------------

def mean_seconds(start: float, end: float, count: int) -> float:
    """The window's time a proof: the window runs whole proofs back to back
    and is stretched to the end of the last one."""
    if count < 1:
        raise ValueError("no proof finished in the window")
    return (end - start) / count


def phase_sum(proof: dict, labels) -> float:
    """Seconds of the named prover phases in one proof; a label the prove
    did not record raises KeyError."""
    got = {}
    for label, seconds in proof["phases"]:
        got[label] = got.get(label, 0.0) + seconds
    return sum(got[label] for label in labels)


def phase_mean(record: dict, labels) -> float:
    proofs = record["window"]["proofs"]
    return sum(phase_sum(p, labels) for p in proofs) / len(proofs)


# -- the device trace ---------------------------------------------------------------

# the port's C kernels by a piece of their demangled device name, most
# specific first (profile_prove.py's table)
SHORT = [("walk_kernel", "ec_madd_walk"),
         ("gl_ntt_leaf_kernel<4, true", "gl_ntt_leaf_fused"),
         ("gl_ntt_leaf_kernel", "gl_ntt_leaf"),
         ("ntt_leaf_kernel<3, true", "ntt_leaf_fused"),
         ("ntt_leaf_kernel", "ntt_leaf"), ("::binop_kernel<2>", "fp252_mul"),
         ("::binop_kernel<0>", "fp252_add"),
         ("::binop_kernel<1>", "fp252_sub"),
         ("gl_binop_kernel<2>", "gl_mul"), ("gl_binop_kernel<0>", "gl_add"),
         ("gl_binop_kernel<1>", "gl_sub"), ("gl3_mul_kernel", "gl3_mul"),
         ("gl_open_pairs_kernel<GL", "gl_open_pairs"),
         ("open_pairs_kernel", "open_pairs"),
         ("blake2s_kernel", "blake2s_rows"),
         ("keccak_kernel", "keccak_rows"), ("grind_kernel", "pow_grind"),
         ("scan_kernel<GL", "gl_scan_mul"),
         ("fold_kernel<GL", "gl_fri_fold"),
         ("fold_kernel_occ<GL", "gl_fri_fold"),
         ("fold_kernel<FPF", "fp252_fri_fold"),
         ("scale_pad_kernel<GL", "gl_scale_pad"),
         ("scale_pad_kernel<FPF", "fp252_scale_pad"),
         ("affine_kernel", "fp252_affine_scan"),
         ("inv_tile_kernel<GL", "gl_batch_inv"),
         ("deep_kernel<GL", "gl_deep_compose"),
         ("scan_kernel", "fp252_scan_mul"),
         ("inv_forward_kernel", "fp252_batch_inv"),
         ("inv_backward_kernel", "fp252_batch_inv"),
         ("deep_kernel", "deep_compose"),
         ("::Tabs", "air_group")]
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    return next((short for key, short in SHORT if key in name), name[:80])


def device_events(events):
    """The trace's device intervals: kernels, copies and sets."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES]


def busy_intervals(events):
    """The union of the events' [ts, ts + dur) intervals (us), in order."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ms(events) -> float:
    """Length of the union of the device intervals, ms."""
    return sum(b - a for a, b in busy_intervals(events)) / 1e3


def busy_ms_within(intervals, lo: float, hi: float) -> float:
    """ms of the busy intervals (busy_intervals) inside [lo, hi) us."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in intervals) / 1e3


def device_ms_by_kernel(device):
    """{name: (device ms, count)}: a kernel of the port by its C entry's
    name, any other kernel by its own, copies and sets by their category."""
    by_name = {}
    for e in device:
        name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e["dur"] / 1e3, n + 1)
    return by_name


def phase_intervals(start_us: float, phases):
    """[(label, start, end)] in us of a prove that started at start_us on
    the profiler's clock, from its phases' seconds in order."""
    out, t = [], start_us
    for label, seconds in phases:
        out.append((label, t, t + seconds * 1e6))
        t += seconds * 1e6
    return out


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps (start, length us) between busy intervals inside [lo, hi)."""
    gaps, t = [], lo
    for a, b in intervals:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            gaps.append((t, a - t))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi - t))
    return gaps


# -- the LDE's least time ---------------------------------------------------------

def lde_products(n: int, blowup: int, columns: int) -> int:
    """Fp252 products of interpolating `columns` columns of n rows and
    evaluating them on `blowup` cosets of n: (1 + blowup) radix-2
    transforms of n points a column, n/2 log2 n butterflies each."""
    return columns * (1 + blowup) * (n // 2) * (n.bit_length() - 1)


def lde_bytes(n: int, blowup: int, columns: int) -> int:
    """Each column's n elements read once and its blowup * n written once."""
    return columns * (1 + blowup) * n * FP252_BYTES


def lde_least_s(n: int, blowup: int, columns: int, sm_count: int,
                max_sm_clock_hz: float) -> float:
    """The larger of the multiply-adds over the card's peak rate and the
    bytes over its bandwidth."""
    mads = lde_products(n, blowup, columns) * MADS_PER_FP252_PRODUCT
    rate = MADS_PER_CLOCK_PER_SM * sm_count * max_sm_clock_hz
    return max(mads / rate, lde_bytes(n, blowup, columns) / HBM_BYTES_PER_S)
