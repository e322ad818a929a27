"""The NST engine: on-device L-BFGS / Adam in image space."""

from .lbfgs import LBFGSState, lbfgs_init, lbfgs_step
from .nst import NSTResult, cached_nst_program, make_nst_fn, nst
