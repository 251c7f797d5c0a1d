"""ITensors.jl-compatible HDF5 serialization.

JAX rebuild of tensor4all-hdf5 (crates/tensor4all-hdf5/src/
lib.rs:150-395 `save/load_itensor`, `save/load_mps`; schema.rs type/version
attributes; index.rs Index/IndexSet groups; itensor.rs Dense storage;
mps.rs MPS metadata). The on-disk layout follows the ITensors.jl schema:

- every object group carries string attr ``type`` + i64 attr ``version``;
- Index: scalar datasets id (u64), dim/dir/plev (i64), attr space_type "Int",
  subgroup tags/ with a comma-joined string dataset;
- IndexSet: dataset length + 1-indexed subgroups index_1..;
- ITensor: inds/ + storage/ (``Dense{Float64}`` | ``Dense{ComplexF64}``,
  column-major flattened ``data``);
- MPS: length/llim/rlim datasets + 1-indexed ``MPS[k]`` ITensor groups.

Backend: h5py (the reference's link-time vs dlopen backend split,
backend.rs:12-16, is a Rust linking concern with no Python analog).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.index import Index, TagSet
from ..core.tensor import Tensor


def _h5py():
    try:
        import h5py
        return h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("hdf5 io requires h5py") from e


def _write_type_version(group, type_name: str, version: int = 1) -> None:
    group.attrs["type"] = str(type_name)
    group.attrs["version"] = np.int64(version)


def _attr_str(group, name: str) -> str:
    """Read a string attribute in any of the dialects the reference's
    compat shim accepts (compat.rs:16-47): variable-length (our writer)
    or fixed-length null-padded UTF-8 (ITensors.jl via HDF5.jl)."""
    v = group.attrs[name]
    if isinstance(v, bytes):
        v = v.decode("utf-8", errors="replace")
    return str(v).rstrip("\x00")


def _require_type(group, expected: str) -> None:
    t = _attr_str(group, "type")
    if expected not in t:
        raise ValueError(f"expected HDF5 type {expected!r}, found {t!r}")


def _write_index(group, index: Index) -> None:
    _write_type_version(group, "Index", 1)
    # ITensors.jl stores this as a *group attribute* (ref
    # tensor4all-hdf5/src/index.rs:85-91 `@space_type`), not a dataset.
    group.attrs["space_type"] = "Int"
    group.create_dataset("id", data=np.uint64(index.id))
    group.create_dataset("dim", data=np.int64(index.dim))
    group.create_dataset("dir", data=np.int64(0))
    group.create_dataset("plev", data=np.int64(index.plev))
    tg = group.create_group("tags")
    _write_type_version(tg, "TagSet", 1)
    tg.create_dataset("tags", data=str(index.tags))


def _read_string(ds) -> str:
    v = ds[()]
    if isinstance(v, bytes):
        v = v.decode("utf-8", errors="replace")
    return str(v).rstrip("\x00")


def _read_index(group) -> Index:
    _require_type(group, "Index")
    idv = int(group["id"][()])
    dim = int(group["dim"][()])
    plev = int(group["plev"][()])
    tags = ""
    if "tags" in group and "tags" in group["tags"]:
        tags = _read_string(group["tags"]["tags"])
    return Index(dim=dim, tags=TagSet(tags), plev=plev, id=idv)


def _write_index_set(group, indices: Sequence[Index]) -> None:
    _write_type_version(group, "IndexSet", 1)
    group.create_dataset("length", data=np.int64(len(indices)))
    for k, ind in enumerate(indices):
        _write_index(group.create_group(f"index_{k + 1}"), ind)


def _read_index_set(group) -> List[Index]:
    n = int(group["length"][()])
    return [_read_index(group[f"index_{k + 1}"]) for k in range(n)]


def save_itensor(path: str, name: str, tensor: Tensor, mode: str = "a") -> None:
    """Write a Tensor as an ITensors.jl `ITensor` group (ref lib.rs:150)."""
    h5py = _h5py()
    with h5py.File(path, mode) as f:
        if name in f:
            del f[name]
        g = f.create_group(name)
        _write_type_version(g, "ITensor", 1)
        _write_index_set(g.create_group("inds"), tensor.indices)
        sg = g.create_group("storage")
        data = np.asarray(tensor.data)
        if np.iscomplexobj(data):
            _write_type_version(sg, "Dense{ComplexF64}", 1)
            payload = data.astype(np.complex128).flatten(order="F")
        else:
            _write_type_version(sg, "Dense{Float64}", 1)
            payload = data.astype(np.float64).flatten(order="F")
        sg.create_dataset("data", data=payload)


def load_itensor(path: str, name: str) -> Tensor:
    """Read an ITensors.jl `ITensor` group (ref lib.rs:243)."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        g = f[name]
        _require_type(g, "ITensor")
        indices = _read_index_set(g["inds"])
        sg = g["storage"]
        st = _attr_str(sg, "type")
        data = np.asarray(sg["data"][()])
        if "ComplexF64" in st:
            if data.dtype.names:  # compound (r, i) layout from HDF5
                data = data["r"] + 1j * data["i"]
            data = data.astype(np.complex128)
        elif "Float64" in st:
            data = data.astype(np.float64)
        else:
            raise ValueError(f"unsupported storage type {st!r}")
        shape = [i.dim for i in indices]
        return Tensor(tuple(indices), data.reshape(shape, order="F"))


def save_mps(path: str, name: str, mps, mode: str = "a") -> None:
    """Write an MPS (mps.MPS or plain tt.TensorTrain) as an
    ITensorMPS.jl `MPS` group (ref lib.rs:298)."""
    from ..mps.mps import MPS
    from ..tt.tensortrain import TensorTrain as PlainTT

    if isinstance(mps, PlainTT):
        mps = MPS.from_tt(mps)
    h5py = _h5py()
    with h5py.File(path, mode) as f:
        if name in f:
            del f[name]
        g = f.create_group(name)
        _write_type_version(g, "MPS", 1)
        g.create_dataset("length", data=np.int64(mps.L))
        g.create_dataset("llim", data=np.int64(mps.llim))
        g.create_dataset("rlim", data=np.int64(mps.rlim))
        for k in range(mps.L):
            tg = g.create_group(f"MPS[{k + 1}]")
            t = mps.tensor(k)
            _write_type_version(tg, "ITensor", 1)
            _write_index_set(tg.create_group("inds"), t.indices)
            sg = tg.create_group("storage")
            data = np.asarray(t.data)
            if np.iscomplexobj(data):
                _write_type_version(sg, "Dense{ComplexF64}", 1)
                sg.create_dataset(
                    "data", data=data.astype(np.complex128).flatten(order="F")
                )
            else:
                _write_type_version(sg, "Dense{Float64}", 1)
                sg.create_dataset(
                    "data", data=data.astype(np.float64).flatten(order="F")
                )


def load_mps(path: str, name: str):
    """Read an ITensorMPS.jl `MPS` group into mps.MPS (ref lib.rs:395)."""
    from ..mps.mps import MPS
    from ..treetn.network import TreeTN

    h5py = _h5py()
    with h5py.File(path, "r") as f:
        g = f[name]
        _require_type(g, "MPS")
        L = int(g["length"][()])
        llim = int(g["llim"][()])
        rlim = int(g["rlim"][()])
        tensors = []
        for k in range(L):
            tg = g[f"MPS[{k + 1}]"]
            indices = _read_index_set(tg["inds"])
            sg = tg["storage"]
            st = _attr_str(sg, "type")
            data = np.asarray(sg["data"][()])
            if "ComplexF64" in st:
                if data.dtype.names:
                    data = data["r"] + 1j * data["i"]
                data = data.astype(np.complex128)
            else:
                data = data.astype(np.float64)
            shape = [i.dim for i in indices]
            tensors.append(Tensor(tuple(indices),
                                  data.reshape(shape, order="F")))
    # reconstruct the chain: shared indices between neighbors are links
    tn = TreeTN.from_tensors({k: t for k, t in enumerate(tensors)})
    sites = []
    for k in range(L):
        s = tn.site_indices(k)
        if len(s) != 1:
            raise ValueError(f"site {k} has {len(s)} site indices")
        sites.append(s[0])
    return MPS(tn, sites, llim=llim, rlim=rlim)


def append_itensor(path: str, name: str, tensor: Tensor) -> None:
    """Append into an existing (or new) file; the name must be fresh
    (ref lib.rs:187)."""
    h5py = _h5py()
    import os

    if os.path.exists(path):
        with h5py.File(path, "r") as f:
            if name in f:
                raise ValueError(f"group {name!r} already exists")
    save_itensor(path, name, tensor, mode="a")


def append_mps(path: str, name: str, mps) -> None:
    """Append an MPS under a fresh name (ref lib.rs:339)."""
    h5py = _h5py()
    import os

    if os.path.exists(path):
        with h5py.File(path, "r") as f:
            if name in f:
                raise ValueError(f"group {name!r} already exists")
    save_mps(path, name, mps, mode="a")
