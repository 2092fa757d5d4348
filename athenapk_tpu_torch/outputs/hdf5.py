"""Block-structured HDF5 dumps (``.phdf``) in the Parthenon output schema:
the port's copy of ``athenapk_tpu/outputs/hdf5.py`` (numpy + h5py, no
tensors).  Callers hand it numpy arrays (``tensor.cpu().numpy()``); for the
same state it writes the file the JAX package writes, attribute for
attribute and dataset for dataset, so the reference's analysis toolchain
(``scripts/parthenon_tools/``: ``phdf``, ``phdf_diff``,
``compare_analytic``) reads it.

Schema summary (uniform and mixed-level dumps share it):

  /Info                 attrs: Time, dt, NCycle, NumDims, NumMeshBlocks,
                        MaxLevel, MeshBlockSize, IncludesGhost, NGhost,
                        Coordinates, RootGridDomain (min,max,rat per dim),
                        RootGridSize, BoundaryConditions,
                        OutputFormatVersion, DatasetNames, NumComponents,
                        ComponentNames ("<dataset>_<label>")
  /Levels               [nb]      per-block refinement level
  /LogicalLocations     [nb, 3]   per-block (lx1, lx2, lx3)
  /Blocks/xmin          [nb, 3]   block origin (x, y, z)
  /Blocks/loc.level-gid-lid  [nb, 3]
  /Locations/{x,y,z}    [nb, n+1] cell FACE coordinates
  /VolumeLocations/{x,y,z}  [nb, n] cell centers
  /cons | /prim         [nb, nvar, nz, ny, nx] interior data
  /<swarm name>/<var>   compacted particle data (+ SwarmVars attrs)

Component labels match the reference registration exactly
(``src/hydro/hydro.cpp:746-775``).

``h5py`` is imported only inside the functions that touch a file
(``require_h5py``), so the port imports where h5py is not installed; a
simulation with an hdf5 or rst output block calls ``require_h5py`` when it
is built, so a missing h5py shows before the run, not at its first dump.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core.mesh import Mesh


def require_h5py():
    """The ``h5py`` module, or an ImportError that names it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "hdf5 and rst outputs (.phdf, .rhdf) need the h5py package, "
            "which this Python cannot import; run the deck without its "
            "hdf5/rst output blocks, or where h5py is installed") from e
    return h5py

_CONS_LABELS = {
    "euler": ["density", "momentum_density_1", "momentum_density_2",
              "momentum_density_3", "total_energy_density"],
    "glmmhd": ["density", "momentum_density_1", "momentum_density_2",
               "momentum_density_3", "total_energy_density",
               "magnetic_field_1", "magnetic_field_2", "magnetic_field_3",
               "magnetic_psi"],
}
_PRIM_LABELS = {
    "euler": ["density", "velocity_1", "velocity_2", "velocity_3",
              "pressure"],
    "glmmhd": ["density", "velocity_1", "velocity_2", "velocity_3",
               "pressure", "magnetic_field_1", "magnetic_field_2",
               "magnetic_field_3", "magnetic_psi"],
}


def _labels(kind: str, fluid: str, nvar: int):
    base = (_CONS_LABELS if kind == "cons" else _PRIM_LABELS)[fluid]
    nscal = nvar - len(base)
    suffix = "scalar_density_{}" if kind == "cons" else "scalar_{}"
    return base + [suffix.format(i) for i in range(nscal)]


def _write_parthenon(filename: str, *, datasets, labels, levels, loglocs,
                     xf, yf, zf, xc, yc, zc, xmin, time, dt, ncycle,
                     ndim, mb_size, root_size, root_domain, nghost, bcs,
                     max_level, extra_params=None, swarms=None,
                     single_precision=False):
    """Shared Parthenon-schema writer.

    ``datasets``: {name: [nb, nvar, nz, ny, nx]} interior data;
    ``labels``: {name: [component label]}.
    """
    h5py = require_h5py()

    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    out_dtype = np.float32 if single_precision else np.float64
    nb = len(levels)
    with h5py.File(filename, "w") as fh:
        info = fh.create_group("Info")
        info.attrs["Time"] = float(time)
        info.attrs["dt"] = float(dt)
        info.attrs["NCycle"] = int(ncycle)
        info.attrs["NumDims"] = int(ndim)
        info.attrs["NumMeshBlocks"] = int(nb)
        info.attrs["MaxLevel"] = int(max_level)
        info.attrs["MeshBlockSize"] = np.asarray(mb_size, np.int32)
        info.attrs["IncludesGhost"] = 0
        info.attrs["NGhost"] = int(nghost)
        info.attrs["Coordinates"] = "UniformCartesian"
        info.attrs["RootGridSize"] = np.asarray(root_size, np.int32)
        info.attrs["RootGridDomain"] = np.asarray(root_domain, np.float64)
        info.attrs["BoundaryConditions"] = np.array(
            [b.encode() for b in bcs])
        info.attrs["OutputFormatVersion"] = 4
        info.attrs["BlocksPerPE"] = np.asarray([nb], np.int32)
        ds_names = sorted(datasets)
        info.attrs["DatasetNames"] = np.array(
            [n.encode() for n in ds_names])
        info.attrs["NumComponents"] = np.asarray(
            [len(labels[n]) for n in ds_names], np.int32)
        comp_names = [f"{n}_{lab}" for n in ds_names for lab in labels[n]]
        info.attrs["ComponentNames"] = np.array(
            [c.encode() for c in comp_names])
        info.attrs["NumVariables"] = len(ds_names)
        if swarms:
            info.attrs["SwarmNames"] = np.array(
                [s.encode() for s in sorted(swarms)])

        if extra_params:
            par = fh.create_group("Params")
            for k, v in extra_params.items():
                par.attrs[k] = v

        fh.create_dataset("Levels", data=np.asarray(levels, np.int64))
        fh.create_dataset("LogicalLocations",
                          data=np.asarray(loglocs, np.int64))
        blk = fh.create_group("Blocks")
        blk.create_dataset("xmin", data=np.asarray(xmin, np.float64))
        gids = np.arange(nb, dtype=np.int64)
        blk.create_dataset("loc.level-gid-lid", data=np.stack(
            [np.asarray(levels, np.int64), gids, gids], axis=1))

        loc = fh.create_group("Locations")
        loc.create_dataset("x", data=np.asarray(xf, np.float64))
        loc.create_dataset("y", data=np.asarray(yf, np.float64))
        loc.create_dataset("z", data=np.asarray(zf, np.float64))
        vloc = fh.create_group("VolumeLocations")
        vloc.create_dataset("x", data=np.asarray(xc, np.float64))
        vloc.create_dataset("y", data=np.asarray(yc, np.float64))
        vloc.create_dataset("z", data=np.asarray(zc, np.float64))

        for name in ds_names:
            fh.create_dataset(name,
                              data=np.asarray(datasets[name], out_dtype))
        if swarms:
            for sname, fields in swarms.items():
                g = fh.create_group(sname)
                for var, data in fields.items():
                    d = np.asarray(data)
                    if d.dtype.kind == "f" and single_precision:
                        d = d.astype(np.float32)
                    g.create_dataset(var, data=d)
                g.attrs["SwarmVars"] = np.array(
                    [v.encode() for v in sorted(fields)])
                g.attrs["NumParticles"] = len(next(iter(fields.values()))) \
                    if fields else 0


def _faces_centers(origin, dx, n):
    f = origin + dx * np.arange(n + 1, dtype=np.float64)
    return f, 0.5 * (f[:-1] + f[1:])


def write_phdf(filename: str, mesh: Mesh, fluid: str, t, dt, ncycle,
               cons: Optional[np.ndarray] = None,
               prim: Optional[np.ndarray] = None,
               single_precision: bool = False,
               extra_params: Optional[dict] = None,
               write_xdmf: bool = True,
               swarms: Optional[dict] = None):
    """Uniform-mesh dump in the Parthenon schema.

    ``swarms``: {name: {var: np.ndarray[n_active]}} — compacted swarm
    data written as one HDF5 group per swarm (the reference's
    ``swarms = tracers`` output-block option, ``docs/input.md``)."""
    sl = mesh.interior_slices
    nb = mesh.nblocks
    nz, ny, nx = mesh.mbnx3, mesh.mbnx2, mesh.mbnx1
    datasets, labels = {}, {}
    for name, arr in (("cons", cons), ("prim", prim)):
        if arr is None:
            continue
        data = np.asarray(arr)[sl]
        datasets[name] = data
        labels[name] = _labels(name, fluid, data.shape[1])

    xf = np.empty((nb, nx + 1))
    yf = np.empty((nb, ny + 1))
    zf = np.empty((nb, nz + 1))
    xc = np.empty((nb, nx))
    yc = np.empty((nb, ny))
    zc = np.empty((nb, nz))
    xmin = np.empty((nb, 3))
    loglocs = np.empty((nb, 3), np.int64)
    for b in range(nb):
        x0, y0, z0 = mesh.block_origin(b)
        xf[b], xc[b] = _faces_centers(x0, mesh.dx1, nx)
        yf[b], yc[b] = _faces_centers(y0, mesh.dx2, ny)
        zf[b], zc[b] = _faces_centers(z0, mesh.dx3, nz)
        xmin[b] = (x0, y0, z0)
        loglocs[b] = (b % mesh.nb1, (b // mesh.nb1) % mesh.nb2,
                      b // (mesh.nb1 * mesh.nb2))

    _write_parthenon(
        filename, datasets=datasets, labels=labels,
        levels=np.zeros(nb, np.int64), loglocs=loglocs,
        xf=xf, yf=yf, zf=zf, xc=xc, yc=yc, zc=zc, xmin=xmin,
        time=t, dt=dt, ncycle=ncycle, ndim=mesh.ndim,
        mb_size=[nx, ny, nz], root_size=[mesh.nx1, mesh.nx2, mesh.nx3],
        root_domain=[mesh.x1min, mesh.x1max, 1.0,
                     mesh.x2min, mesh.x2max, 1.0,
                     mesh.x3min, mesh.x3max, 1.0],
        nghost=mesh.nghost,
        bcs=[mesh.ix1_bc, mesh.ox1_bc, mesh.ix2_bc, mesh.ox2_bc,
             mesh.ix3_bc, mesh.ox3_bc],
        max_level=0, extra_params=extra_params, swarms=swarms,
        single_precision=single_precision)
    if write_xdmf:
        _write_xdmf(filename, mesh, fluid, t, cons is not None,
                    prim is not None,
                    {k: v.shape[1] for k, v in datasets.items()})


def _xdmf_labels(kind, fluid, nvar):
    return _labels(kind, fluid, nvar)


def _write_xdmf(h5name: str, mesh: Mesh, fluid: str, t, has_cons, has_prim,
                nvars=None):
    """XDMF sidecar so ParaView/VisIt can open the dumps (the reference's
    Parthenon outputs ship .xdmf next to each .phdf)."""
    import os as _os
    base = _os.path.basename(h5name)
    lines = ['<?xml version="1.0" ?>',
             '<Xdmf Version="3.0">', '<Domain>',
             f'<Grid Name="mesh" GridType="Collection" '
             f'CollectionType="Spatial">',
             f'<Time Value="{float(t)}"/>']
    nb = mesh.nblocks
    nz, ny, nx = mesh.mbnx3, mesh.mbnx2, mesh.mbnx1
    for b in range(nb):
        x0, y0, z0 = mesh.block_origin(b)
        lines += [
            f'<Grid Name="block{b}" GridType="Uniform">',
            f'<Topology TopologyType="3DCoRectMesh" '
            f'Dimensions="{nz + 1} {ny + 1} {nx + 1}"/>',
            '<Geometry GeometryType="ORIGIN_DXDYDZ">',
            f'<DataItem Dimensions="3" Format="XML">'
            f'{z0} {y0} {x0}</DataItem>',
            f'<DataItem Dimensions="3" Format="XML">'
            f'{mesh.dx3} {mesh.dx2} {mesh.dx1}</DataItem>',
            '</Geometry>']
        for kind, present in (("cons", has_cons), ("prim", has_prim)):
            if not present:
                continue
            nvar = (nvars or {}).get(
                kind, len((_CONS_LABELS if kind == "cons"
                           else _PRIM_LABELS)[fluid]))
            labels = _xdmf_labels(kind, fluid, nvar)
            for vi, lab in enumerate(labels):
                lines += [
                    f'<Attribute Name="{kind}_{lab}" Center="Cell">',
                    f'<DataItem ItemType="HyperSlab" '
                    f'Dimensions="1 1 {nz} {ny} {nx}" Type="HyperSlab">',
                    f'<DataItem Dimensions="3 5" Format="XML">'
                    f'{b} {vi} 0 0 0  1 1 1 1 1  1 1 {nz} {ny} {nx}'
                    f'</DataItem>',
                    f'<DataItem Format="HDF" Dimensions='
                    f'"{nb} {nvar} {nz} {ny} {nx}">'
                    f'{base}:/{kind}</DataItem>',
                    '</DataItem>', '</Attribute>']
        lines.append('</Grid>')
    lines += ['</Grid>', '</Domain>', '</Xdmf>']
    with open(h5name + ".xdmf", "w") as fh:
        fh.write("\n".join(lines))


class PhdfData:
    """Loaded dump: attributes mirror what the regression suites need.

    Thin in-package reader over the Parthenon schema; the full-featured
    reference-compatible reader is ``scripts/parthenon_tools/phdf.py``.
    """

    def __init__(self, filename):
        h5py = require_h5py()

        with h5py.File(filename, "r") as fh:
            info = fh["Info"].attrs
            self.time = float(info["Time"])
            self.ncycle = int(info["NCycle"])
            self.num_blocks = int(info["NumMeshBlocks"])
            self.block_size = tuple(info["MeshBlockSize"])
            self.root_grid = tuple(info["RootGridSize"])
            dom = np.asarray(info["RootGridDomain"])
            self.domain = (dom[0], dom[1], dom[3], dom[4], dom[6], dom[7])
            self.max_level = int(info["MaxLevel"])
            self.levels = fh["Levels"][()]
            self.logical_locations = fh["LogicalLocations"][()]
            self.x = fh["VolumeLocations/x"][()]
            self.y = fh["VolumeLocations/y"][()]
            self.z = fh["VolumeLocations/z"][()]
            self.xf = fh["Locations/x"][()]
            self.yf = fh["Locations/y"][()]
            self.zf = fh["Locations/z"][()]
            self.data = {}
            self.var_names = {}
            ds_names = [s.decode() for s in info["DatasetNames"]]
            all_comps = [s.decode() for s in info["ComponentNames"]]
            ncomps = list(info["NumComponents"])
            off = 0
            for name, nc in zip(ds_names, ncomps):
                self.data[name] = fh[name][()]
                self.var_names[name] = [
                    c[len(name) + 1:] for c in all_comps[off:off + nc]]
                off += nc
            self.swarms = {}
            for name in fh:
                if isinstance(fh[name], h5py.Group) and \
                        "NumParticles" in fh[name].attrs:
                    self.swarms[name] = {k: fh[name][k][()]
                                         for k in fh[name]}

    def flat(self, kind: str):
        """Reassemble blocks into one global array [nvar, NZ, NY, NX].

        Assumes the regular block ordering of ``Mesh`` (x fastest) and a
        single-level dump.
        """
        arr = self.data[kind]
        nb, nvar, bz, by, bx = arr.shape
        nx1, nx2, nx3 = self.root_grid
        n1, n2, n3 = nx1 // bx, nx2 // by, nx3 // bz
        grid = arr.reshape(n3, n2, n1, nvar, bz, by, bx)
        grid = grid.transpose(3, 0, 4, 1, 5, 2, 6)
        return grid.reshape(nvar, nx3, nx2, nx1)


def read_phdf(filename) -> PhdfData:
    return PhdfData(filename)


def write_phdf_smr(filename: str, smesh, fluid: str, t, dt, ncycle,
                   state=None, prim_state=None,
                   single_precision: bool = False,
                   extra_params: Optional[dict] = None,
                   write_xdmf: bool = True,
                   swarms: Optional[dict] = None):
    """Refined-mesh dump: every leaf is a block with its own coordinates
    and level (Parthenon's mixed-level .phdf layout — per-block face +
    center Locations plus /Levels and /LogicalLocations).

    ``state``/``prim_state``: {level: [nb, nvar, NZ, NY, NX]} batched
    leaf arrays (ghost-inclusive); written in global leaf-id order.
    """
    b = smesh.base
    g1, g2, g3 = b.ng1, b.ng2, b.ng3
    nz, ny, nx = b.mbnx3, b.mbnx2, b.mbnx1
    nleaves = int(smesh.levels.size)

    def gather(st):
        nvar = next(iter(st.values())).shape[1]
        data = np.empty((nleaves, nvar, nz, ny, nx), np.float64)
        for lev, ids in smesh.level_ids.items():
            arr = np.asarray(st[lev])[:, :, g3:g3 + nz, g2:g2 + ny,
                                      g1:g1 + nx]
            data[ids] = arr
        return data

    datasets, labels = {}, {}
    for name, st in (("cons", state), ("prim", prim_state)):
        if st is None:
            continue
        data = gather(st)
        datasets[name] = data
        labels[name] = _labels(name, fluid, data.shape[1])

    xf = np.empty((nleaves, nx + 1))
    yf = np.empty((nleaves, ny + 1))
    zf = np.empty((nleaves, nz + 1))
    xc = np.empty((nleaves, nx))
    yc = np.empty((nleaves, ny))
    zc = np.empty((nleaves, nz))
    xmin = np.empty((nleaves, 3))
    for gid in range(nleaves):
        lev = int(smesh.levels[gid])
        d1, d2, d3 = smesh.dx(lev)
        x0, y0, z0 = smesh.block_origin(gid)
        xf[gid], xc[gid] = _faces_centers(x0, d1, nx)
        yf[gid], yc[gid] = _faces_centers(y0, d2, ny)
        zf[gid], zc[gid] = _faces_centers(z0, d3, nz)
        xmin[gid] = (x0, y0, z0)

    _write_parthenon(
        filename, datasets=datasets, labels=labels,
        levels=smesh.levels,
        loglocs=np.stack([smesh.lx1, smesh.lx2, smesh.lx3], axis=1),
        xf=xf, yf=yf, zf=zf, xc=xc, yc=yc, zc=zc, xmin=xmin,
        time=t, dt=dt, ncycle=ncycle, ndim=b.ndim,
        mb_size=[nx, ny, nz], root_size=[b.nx1, b.nx2, b.nx3],
        root_domain=[b.x1min, b.x1max, 1.0, b.x2min, b.x2max, 1.0,
                     b.x3min, b.x3max, 1.0],
        nghost=b.nghost,
        bcs=[b.ix1_bc, b.ox1_bc, b.ix2_bc, b.ox2_bc, b.ix3_bc, b.ox3_bc],
        max_level=int(smesh.max_level), extra_params=extra_params,
        swarms=swarms, single_precision=single_precision)
    if write_xdmf:
        _write_xdmf_smr(filename, smesh, fluid, t, state is not None,
                        prim_state is not None,
                        {k: v.shape[1] for k, v in datasets.items()})


def _write_xdmf_smr(h5name: str, smesh, fluid: str, t, has_cons,
                    has_prim, nvars=None):
    """XDMF sidecar for mixed-level dumps: per-block origin + level dx."""
    base = os.path.basename(h5name)
    b = smesh.base
    nz, ny, nx = b.mbnx3, b.mbnx2, b.mbnx1
    nleaves = int(smesh.levels.size)
    lines = ['<?xml version="1.0" ?>',
             '<Xdmf Version="3.0">', '<Domain>',
             '<Grid Name="mesh" GridType="Collection" '
             'CollectionType="Spatial">',
             f'<Time Value="{float(t)}"/>']
    for gid in range(nleaves):
        lev = int(smesh.levels[gid])
        d1, d2, d3 = smesh.dx(lev)
        x0, y0, z0 = smesh.block_origin(gid)
        lines += [
            f'<Grid Name="block{gid}" GridType="Uniform">',
            f'<Topology TopologyType="3DCoRectMesh" '
            f'Dimensions="{nz + 1} {ny + 1} {nx + 1}"/>',
            '<Geometry GeometryType="ORIGIN_DXDYDZ">',
            f'<DataItem Dimensions="3" Format="XML">'
            f'{z0} {y0} {x0}</DataItem>',
            f'<DataItem Dimensions="3" Format="XML">'
            f'{d3} {d2} {d1}</DataItem>',
            '</Geometry>']
        for kind, present in (("cons", has_cons), ("prim", has_prim)):
            if not present:
                continue
            nvar = (nvars or {}).get(
                kind, len((_CONS_LABELS if kind == "cons"
                           else _PRIM_LABELS)[fluid]))
            labels = _xdmf_labels(kind, fluid, nvar)
            for vi, lab in enumerate(labels):
                lines += [
                    f'<Attribute Name="{kind}_{lab}" Center="Cell">',
                    f'<DataItem ItemType="HyperSlab" '
                    f'Dimensions="1 1 {nz} {ny} {nx}" Type="HyperSlab">',
                    f'<DataItem Dimensions="3 5" Format="XML">'
                    f'{gid} {vi} 0 0 0  1 1 1 1 1  1 1 {nz} {ny} {nx}'
                    f'</DataItem>',
                    f'<DataItem Format="HDF" Dimensions='
                    f'"{nleaves} {nvar} {nz} {ny} {nx}">'
                    f'{base}:/{kind}</DataItem>',
                    '</DataItem>', '</Attribute>']
        lines.append('</Grid>')
    lines += ['</Grid>', '</Domain>', '</Xdmf>']
    with open(h5name + ".xdmf", "w") as fh:
        fh.write("\n".join(lines))
