"""The yardstick's peaks and the kernels' work, counted from the call's shapes.

A kernel's roofline share is the least time the card could take for the
work its calls need (the larger of the bytes over the memory rate and the
operations over the matching compute peak) over the kernel's device time in
the trace.  The work is counted here from the shapes, whatever implements
the kernel: each input byte read once, each output byte written once, and
the operations the function needs.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W power limit (a card
set lower runs slower under load; the run prints the card's limit beside
the share): HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67
TFLOP/s, int32 at 16.7 T ops/s (64 lanes per SM per clock, 132 SMs, 1.98
GHz).
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAKS = {"fp32": 67e12, "int32": 16.7e12}

# float32 operations a cell of ``fail_prob`` needs: the terms of t that
# depend only on the row, the column or the mat are paid per row, column or
# mat, so a cell costs 3 adds for t and 54 for the two-channel mixture (each
# channel 25: the subtraction, 2 divisions, |x|, the reciprocal's product,
# sum and division, 9 for the polynomial, x*x, the negation, exp (one op),
# its product, 1 - ..., the sign's select and product, 1 + ..., 0.5*...;
# then t + outlier_ns and the two weighted terms).
FAIL_PROB_OPS_PER_CELL = 57
# ``fail_prob_op`` with both channels on: the above, 1 for the voltage
# shift, 61 for the retention mixture on the design slowness (the slowness'
# adds, the margin, its negations and a second two-channel mixture, and the
# sum of the channels).
FAIL_PROB_OP_OPS_PER_CELL = 57 + 1 + 61


def fail_prob_work(D: int, M: int, R: int, C: int, n_coeffs: int = 9,
                   ops_per_cell: int = FAIL_PROB_OPS_PER_CELL) -> dict:
    """One launch over a (D, M, R, C) grid: reads D*R int32 row sources, D
    coefficient rows and M mat delays, writes the float32 grid."""
    cells = D * M * R * C
    return {"ops": cells * ops_per_cell, "peak": "fp32",
            "bytes": cells * 4 + D * R * 4 + D * n_coeffs * 4 + M * 4}


def fail_prob_op_work(D: int, M: int, R: int, C: int) -> dict:
    """``fail_prob_op`` with the voltage shift and the retention channel."""
    return fail_prob_work(D, M, R, C, n_coeffs=15,
                          ops_per_cell=FAIL_PROB_OP_OPS_PER_CELL)


# int32 operations a step of an FR-FCFS walk needs, with the bus and the
# activation window on (the rule of ``reference_eval.walk_totals``), per
# queued request 25: the start (1 max), the row hit (1 compare), the ACT time
# (max, + tRP; tRRD and tFAW: 2 adds, 2 max), the column time (+ tRCD, a
# select), the data time (tCL or tCWL: a select, an add), the bus (max,
# + tBL), the latency (1 sub), the row's close (+ tRAS, a select; a write's
# + tWR, max, select), the request's class (arrived: 1 compare; valid, hit
# and arrived combined: 4); per step, choosing the winner by (class,
# arrival, trace index) 3 compares for each queued request after the first,
# and the winner's update 10: the rank's last ACT (1 max), its four-ACT
# window kept sorted (6 min/max), the clock (1 max), the refill's index and
# its validity (2).
BANK_SCHED_OPS_PER_REQUEST = 25
BANK_SCHED_OPS_PER_STEP = 10
# the SECDED(72,64) parity-check matrix has 216 ones (56 data columns of
# weight 3, 8 of weight 5, the 8 check bits' identity), so a codeword's 8
# syndrome bits take 216 - 8 XORs
SYNDROME_OPS_PER_WORD = 208


def bank_sched_work(T: int, W: int, n: int, queue: int, banks: int) -> dict:
    """One launch walking T timing tables x W traces of ``n`` requests each
    through a ``queue``-deep queue: reads the (W, n, 4) int32 traces and
    the (T, banks, 6) int32 cycle rows, writes each request's int32 latency
    and hit."""
    walks = T * W
    ops = walks * n * (queue * BANK_SCHED_OPS_PER_REQUEST
                       + 3 * (queue - 1) + BANK_SCHED_OPS_PER_STEP)
    return {"ops": ops, "peak": "int32",
            "bytes": W * n * 16 + T * banks * 24 + walks * n * 8}


def syndrome_work(words: int) -> dict:
    """One launch over ``words`` (N, 72) int32 codewords: writes (N, 8)
    int32 syndrome bits."""
    return {"ops": words * SYNDROME_OPS_PER_WORD, "peak": "int32",
            "bytes": words * (72 + 8) * 4}


def permute_work(bursts: int) -> dict:
    """One launch permuting ``bursts`` (N, 576) int32 bursts by a (576,)
    int64 lane index: reads and writes every lane once, no arithmetic."""
    return {"ops": 0, "peak": "int32", "bytes": bursts * 576 * 8 + 576 * 8}


# the kernels' symbols in a device trace: the template's first argument is
# the coefficient count (9 for ``fail_prob``, 15 for ``fail_prob_op``), or
# the codeword width (72 for the syndrome, 64 for the check bits)
SYMBOLS = {"fail_prob": "fail_prob_kernel<9,",
           "fail_prob_op": "fail_prob_kernel<15,",
           "bank_sched": "fast_walk_kernel<",
           "syndrome": "parity_kernel<72,",
           "permute": "permute_kernel<"}


def least_seconds(work: dict) -> float:
    """The least time of one launch's work on the card."""
    return max(work["bytes"] / PEAK_BYTES_PER_S,
               work["ops"] / PEAKS[work["peak"]])


def roofline_percent(work: dict, launches: int, kernel_s: float):
    """Share of the roofline, in percent, of ``launches`` launches of equal
    ``work`` that took ``kernel_s`` seconds of device time; None where the
    trace holds no launch."""
    if launches == 0 or kernel_s <= 0:
        return None
    return 100.0 * launches * least_seconds(work) / kernel_s
