"""Row layout of the packed channel-major particle state.

The port carries the particle state as one ``(NCH, Pw)`` float32 tensor:
channel row r holds one scalar field over all particle lanes. The map is
the JAX package's (``taichi_mpm_tpu/ops/rows.py``), copied so both
packages agree lane for lane.

Row map (int rows bitcast to f32):
   0-2  x        15-23 C         28-35 params
   3-5  v        24    aux       36    active (0/1)
   6-14 F        25    mass      37    states (int)  38 bdist
                 26    vol       39-41 bnormal       42 near_b (0/1)
                 27    mat (int, bitcast)
  43-45 sort-time block origin in grid units (written at every re-sort;
        static between sorts: the lazy-sort contract keeps particles
        within half a cell of this block)
  46    spare
  47    mat as a plain f32 VALUE (0.0..7.0, written at pack time)
"""

NCH = 48  # rows (43 live + origin annotation + matf)

RX, RV, RF, RC = 0, 3, 6, 15
RAUX, RMASS, RVOL, RMAT = 24, 25, 26, 27
RPAR, RACT = 28, 36
RSTATES, RBDIST, RBN, RNEARB = 37, 38, 39, 42
RORG, RMATF = 43, 47
