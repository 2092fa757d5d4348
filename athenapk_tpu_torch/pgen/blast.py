"""Spherical blast wave (reference ``src/pgen/blast.cpp``): over-pressured
sphere with log-smooth density/pressure ramps between inner and outer radii.
(The PBM input-image variant initializes density from a bitmap; supported
via ``input_image``.)"""

from __future__ import annotations

import numpy as np

from ..core.indices import IDN, IEN, IB1, IB2, IB3, GLMMHD


def _load_pbm(path):
    """Minimal P4 (binary) PBM reader for blast_image.in."""
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        assert magic == b"P4", "expect binary PBM"
        line = fh.readline()
        while line.startswith(b"#"):
            line = fh.readline()
        nx, ny = (int(v) for v in line.split())
        data = np.unpackbits(np.frombuffer(fh.read(), dtype=np.uint8))
        row_bits = ((nx + 7) // 8) * 8
        bits = data[:row_bits * ny].reshape(ny, row_bits)[:, :nx]
    return bits[::-1]  # image row 0 is top; flip to y-up


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/blast"
    rout = pin.get_real(p, "radius_outer")
    rin = pin.get_or_add_real(p, "radius_inner", rout)
    pa = pin.get_or_add_real(p, "pressure_ambient", 1.0)
    da = pin.get_or_add_real(p, "density_ambient", 1.0)
    prat = pin.get_real(p, "pressure_ratio")
    drat = pin.get_or_add_real(p, "density_ratio", 1.0)
    gamma = pin.get_or_add_real("hydro", "gamma", 5.0 / 3.0)
    gm1 = gamma - 1.0
    x0 = pin.get_or_add_real(p, "x1_0", 0.0)
    y0 = pin.get_or_add_real(p, "x2_0", 0.0)
    z0 = pin.get_or_add_real(p, "x3_0", 0.0)
    b0 = pin.get_or_add_real(p, "b0", 0.0)  # optional uniform Bx for MHD

    x, y, z = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    rad = np.broadcast_to(
        np.sqrt((x - x0) ** 2 + (y - y0) ** 2 + (z - z0) ** 2), shape)

    input_image = pin.get_or_add_string(p, "input_image", "none")
    if input_image != "none":
        img = _load_pbm(input_image)
        ny_img, nx_img = img.shape
        xb = np.broadcast_to(x, shape)
        yb = np.broadcast_to(y, shape)
        xi = np.clip(((xb - mesh.x1min) / (mesh.x1max - mesh.x1min)
                      * nx_img).astype(int), 0, nx_img - 1)
        yi = np.clip(((yb - mesh.x2min) / (mesh.x2max - mesh.x2min)
                      * ny_img).astype(int), 0, ny_img - 1)
        den = np.where(img[yi, xi] != 0, drat * da, da)
    else:
        f = np.clip((rad - rin) / max(rout - rin, 1e-300), 0.0, 1.0)
        log_den = (1.0 - f) * np.log(drat * da) + f * np.log(da)
        den = np.where(rad < rout, np.exp(log_den), da)

    f = np.clip((rad - rin) / max(rout - rin, 1e-300), 0.0, 1.0)
    log_pres = (1.0 - f) * np.log(prat * pa) + f * np.log(pa)
    pres = np.where(rad < rout, np.exp(log_pres), pa)

    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = den
    u[:, IEN] = pres / gm1
    if cfg.fluid == GLMMHD and b0 != 0.0:
        u[:, IB1] = b0
        u[:, IEN] += 0.5 * b0 * b0
    return u
