"""The demos: ``nst_demo`` (classic Gatys NST of an image pair) and
``iris_nst_demo`` (RITnet mask and crop -> style-only NST -> composite)."""
