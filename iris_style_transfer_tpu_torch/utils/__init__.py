"""Seeding, directory preparation, sweep markers and PNG output."""

from .misc import prepare_dir, save_png, seed, sweep_done, write_sweep_marker
from .png import read_png, read_png_gray, write_png
