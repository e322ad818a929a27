"""Seeding, directory preparation, sweep markers, notebook plotting, and image
I/O: PNG and JPEG reading (``decode.py``), PNG writing."""

from .misc import plot_help, prepare_dir, save_png, seed, sweep_done, write_sweep_marker
from .decode import image_size, read_image, read_image_gray
from .png import read_png, read_png_gray, write_png
