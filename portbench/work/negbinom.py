"""The frozen work model of a negative-binomial BTF sweep: the operations
the inputs need, each special function (log, lgamma, rsqrt, tanh, ...) one
operation, whatever computes them. It feeds ``flops_per_sweep``, so that
``sweep_mfu`` covers the whole step: the R moves, the Polya-Gamma draw,
the W rows' and the V columns' Gaussian draws. The prior's re-draws
(sigma2, Tau2, lam2: a few operations a column and a difference) are left
out.
"""

# a Marsaglia-Tsang round of one lane: 1 + c x, its cube, log u, x^2 / 2,
# d - d v, d log v, the sums, the test and the two selects
MT_ROUND = 16
# a lane's set-up (a_eff, d, c) and boost
MT_LANE = 7
# a term of the truncated sum: its denominator, g / denom, the sum, and the
# tail mean's 1 / denom and sum
PG_TERM = 6
# a cell's tail mean (tanh, ratio, clamp), the normal branch's variance and
# draw, the selects
PG_CELL = 20
# a move of one present cell: the four lgammas, Y + R twice, the three
# differences, (Rc - R0) log(1 - P), the mask and the sum
R_CELL = 14


def pg_cell_flops(num_terms, rounds=6):
    """One cell's Polya-Gamma draw by the truncated sum of gammas."""
    return num_terms * (rounds * MT_ROUND + MT_LANE + PG_TERM) + PG_CELL


def band_flops(T, k, tf_order):
    """One column's banded Cholesky (dimension T k, half bandwidth (tf_order
    + 2) k - 1: N w^2) and its three triangular solves (2 N w each)."""
    N, w = T * k, (tf_order + 2) * k - 1
    return N * (w * w + 6 * w)


def sweep_flops(nchains, n, m, T, k, present, *, nmetropolis, num_terms,
                tf_order):
    """A sweep's operations: ``present`` cells of the n x m x T tensor hold
    a count. The R moves and the draw of omega for every present cell, W
    V^T over every cell twice (the moves' success probability with its
    sigmoid and log(1 - P), and psi), the W and V Grams (omega V V^T and
    omega W W^T, 3 k^2, with their mean parts, 2 k), each row's k x k
    Cholesky and solves and each column's banded factorisation."""
    cells = n * m * T
    per_chain = (present * (nmetropolis * R_CELL + pg_cell_flops(num_terms)
                            + 2 * (3 * k * k + 2 * k))
                 + cells * (4 * k + 4)
                 + n * (k ** 3 // 3 + 6 * k * k)
                 + m * band_flops(T, k, tf_order))
    return nchains * per_chain
