"""Checkpoint / resume.

Counterpart of ``dl_esm_inf_tpu/utils/checkpoint.py`` (its ``.npz``
backend).  The reference has none (SURVEY §5: 'Checkpoint / resume:
none'); the closest machinery is gather_inner_data
(field_mod.f90:1313-1390).  A model's prognostic fields are saved as a
portable ``.npz`` of gathered *global* internal arrays plus a JSON
``__meta__`` record (step, field names, format version, caller
attributes), with the JAX package's keys and layout: a checkpoint
written by either package loads in the other.

Restart on a different decomposition works through the global form:
the arrays are gathered to (global_ny, global_nx) and re-scattered into
the target grid's layout.  Across ranks both calls are collective: on
save every rank joins the gather and rank 0 alone writes the file; on
load every rank reads the file and keeps its own block.  The file is the
same whatever the ranks or tiles of the run that wrote it.  The JAX
package's orbax backend (sharded device arrays without a host gather) is
not ported: orbax is a JAX library, and on one card the host gather is
the whole of the data.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..core import kinds, layout
from ..core.field import Field
from ..parallel import environment as env


def save_fields(path: str, fields: dict, step: int = 0,
                attrs: dict | None = None) -> None:
    """Save named fields' *global internal* arrays + metadata to .npz
    (written to a temporary name, then moved into place).  Collective
    across ranks: rank 0 writes, and every rank returns once the file is
    in place."""
    arrays = {}
    meta = {"step": int(step), "names": sorted(fields), "version": 1}
    if attrs:
        meta["attrs"] = attrs
    for name, fld in fields.items():
        if isinstance(fld, Field):
            arrays[name] = fld.gather_inner_data()
        else:
            arrays[name] = np.asarray(fld)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    if env.on_master():
        tmp = path + ".tmp"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    env.barrier()


def load_fields(path: str, fields: dict) -> dict:
    """Restore named fields in place, re-scattering onto each field's
    own decomposition (which may differ from the saving run's), and
    refresh their depth-1 halos.  Returns the metadata dict; plain
    arrays in ``fields`` come back under its ``"arrays"``.  Collective
    across ranks: each rank reads the file and keeps its block."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        loaded = {}
        for name, fld in fields.items():
            if name not in data:
                raise KeyError(f"checkpoint {path} has no field {name!r}")
            g = data[name]
            if isinstance(fld, Field):
                dt = kinds.np_dtype(fld.dtype)
                if fld.levels is not None:
                    if g.shape[0] != fld.levels:
                        raise ValueError(
                            f"checkpoint field {name!r} has {g.shape[0]} "
                            f"levels, field expects {fld.levels}")
                    stacked = np.stack([
                        layout.stack_global(fld.grid.decomp, g[k],
                                            mode="zeros", dtype=dt)
                        for k in range(fld.levels)])
                else:
                    stacked = layout.stack_global(fld.grid.decomp, g,
                                                  mode="zeros", dtype=dt)
                fld.set_data(stacked)
                if fld.grid.decomp.halo > 0:
                    fld.halo_exchange(1)
            else:
                # plain arrays round-trip symmetrically with save_fields
                loaded[name] = g
        if loaded:
            meta = dict(meta, arrays=loaded)
    return meta


def save_model(path: str, model, extra: dict | None = None) -> None:
    """Checkpoint a model exposing ``.checkpoint_fields()`` (or the
    standard NEMOLite2D/GravityWave field names) at its step count."""
    fields, step = _model_fields(model)
    save_fields(path, fields, step=step, attrs=extra)


def load_model(path: str, model) -> dict:
    """Restore :func:`save_model`'s fields and step count into
    ``model``; returns the metadata."""
    fields, _ = _model_fields(model)
    meta = load_fields(path, fields)
    if hasattr(model, "_istep0"):
        model._istep0 = int(meta.get("step", 0))
    return meta


def _model_fields(model):
    if hasattr(model, "checkpoint_fields"):
        return model.checkpoint_fields(), getattr(model, "_istep0", 0)
    names = [n for n in ("sshn_t", "un", "vn", "eta", "u", "v")
             if hasattr(model, n)]
    return ({n: getattr(model, n) for n in names},
            getattr(model, "_istep0", 0))
