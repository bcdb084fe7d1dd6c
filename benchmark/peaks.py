"""Published peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W limit); a copy of chip_smoke.py's."""

#: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12