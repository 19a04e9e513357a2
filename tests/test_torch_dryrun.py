"""The port's dry run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`).

The reference's module sets a 512-device XLA_FLAGS at import, so it is
built in a subprocess of its own (JAX_PLATFORMS=cpu): `build_cell` for
every cell of `shapes_for(arch)` over ARCHS + DLRMS on both production
meshes, the DLRM cells under the `pooled_psum` overrides, nothing lowered.
The subprocess prints each cell's final rules (captured from the
reference's own `specs_to_pspecs` call), its analytic fields, every
parameter and cache leaf's PartitionSpec and `_sharded_gb`, and the DLRM
placement fields; the port's `build_cell` must give the same: integers,
strings and specs exactly, floats bit-equal (the port walks the trees in
jax's sorted-key order, so `_sharded_gb` sums in the reference's order).
The same subprocess prints the reference's `launch.perf.VARIANTS`, which
the port's must equal entry for entry. One cell then runs through
`run_cell` on the meta device, and its record must carry the
reference's keys; a variant the port cannot express is recorded with its
error.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs.base import shapes_for
from repro_torch.configs.registry import ARCHS, DLRMS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = textwrap.dedent('''
    import json, sys
    import repro.launch.dryrun as D
    from jax.sharding import PartitionSpec as P
    from repro.configs import shapes_for
    from repro.configs.registry import ARCHS, DLRMS

    POOLED = {"placement": "row_wise", "lookup_impl": "psum",
              "hbm_budget_gb": 8.0}
    seen = {}
    real_pspecs, real_cache = D.specs_to_pspecs, D.cache_pspecs

    def spy_pspecs(specs, rules, **kw):
        out = real_pspecs(specs, rules, **kw)
        seen.update(specs=specs, rules=dict(rules), pspecs=out)
        return out

    def spy_cache(*a, **kw):
        out = real_cache(*a, **kw)
        seen["cache"] = out
        return out

    D.specs_to_pspecs, D.cache_pspecs = spy_pspecs, spy_cache

    def norm(x):
        if isinstance(x, P) or isinstance(x, tuple) or isinstance(x, list):
            return [norm(e) for e in x]
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        return x

    def paths(tree, pre=""):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(paths(tree[k], f"{pre}/{k}"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(paths(v, f"{pre}/{i}"))
            return out
        return {pre: norm(tree)}

    recs = {}
    for multi in (False, True):
        mesh = D.make_production_mesh(multi_pod=multi)
        for arch in list(ARCHS) + list(DLRMS):
            for name, shape in shapes_for(arch).items():
                seen.clear()
                ov = POOLED if arch in DLRMS else None
                with mesh:
                    _, _, meta = D.build_cell(arch, shape, mesh, None, ov)
                r = {k: meta[k] for k in (
                    "hbm_estimate_gb", "model_flops", "params",
                    "active_params", "accum_steps", "placement",
                    "lookup_bytes", "load_imbalance") if k in meta}
                r["rules"] = norm(seen["rules"])
                r["pspecs"] = paths(seen["pspecs"])
                r["cache"] = paths(seen["cache"]) if "cache" in seen else None
                r["sharded_gb"] = D._sharded_gb(seen["specs"],
                                                seen["pspecs"], mesh)
                recs[f"{arch}/{name}/{int(multi)}"] = r
    import repro.launch.perf as PERF
    sys.stdout.write(json.dumps({"cells": recs,
                                 "variants": norm(PERF.VARIANTS)}))
''')


def _norm(x):
    if isinstance(x, (tuple, list)):
        return [_norm(e) for e in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _paths(tree, pre: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], f"{pre}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{pre}/{i}"))
        return out
    return {pre: _norm(tree)}


@pytest.fixture(scope="module")
def reference() -> dict:
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def reference_cells(reference) -> dict:
    return reference["cells"]


def _port_cells() -> dict:
    recs = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, dry=True)
        for arch in list(ARCHS) + list(DLRMS):
            for name, shape in shapes_for(arch).items():
                ov = dryrun.POOLED_PSUM if arch in DLRMS else None
                cell = dryrun.build_cell(arch, shape, mesh, None, ov)
                r = {k: v for k, v in cell.meta.items()}
                r["rules"] = _norm(cell.rules)
                r["pspecs"] = _paths(cell.pspecs)
                r["cache"] = (None if cell.cache_pspecs is None
                              else _paths(cell.cache_pspecs))
                r["sharded_gb"] = dryrun._sharded_gb(cell.specs, cell.pspecs,
                                                     mesh)
                recs[f"{arch}/{name}/{int(multi)}"] = r
    return recs


def test_every_cell_analytic_fields_equal_the_reference(reference_cells):
    port = _port_cells()
    assert sorted(port) == sorted(reference_cells)
    assert len(port) == 76
    for key, want in reference_cells.items():
        got = port[key]
        assert sorted(got) == sorted(want), key
        for field, w in want.items():
            # ints, strings, specs and rules exactly; floats bit-equal
            assert got[field] == w, (key, field, got[field], w)


def test_run_cell_record_carries_the_reference_keys():
    shape = shapes_for("stablelm-1.6b")["decode_32k"]
    rec = dryrun.run_cell("stablelm-1.6b", shape, False)
    assert rec["ok"], rec.get("traceback")
    reference_keys = {
        "arch", "shape", "mesh", "chips", "ok", "lower_s", "compile_s",
        "memory", "xla_flops_uncorrected", "collective_warnings",
        "per_chip_dot_flops", "compute_s_per_chip", "top_collectives",
        "flops", "vpu_flops", "major_bytes", "gather_bytes",
        "scatter_bytes", "collectives_per_chip", "collective_bytes_per_chip",
        "model_flops", "params", "active_params", "stablehlo_warnings",
        "hbm_estimate_gb", "compute_s", "memory_s", "collective_s",
        "dominant", "bound_s", "model_flops_ratio", "roofline_fraction",
        "total_s"}
    assert reference_keys <= set(rec), reference_keys - set(rec)
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_per_device"}
    mem = rec["memory"]
    assert mem["peak_per_device"] == (mem["argument_bytes"]
                                      + mem["output_bytes"]
                                      + mem["temp_bytes"]
                                      - mem["alias_bytes"])
    assert rec["fits"] and rec["chips"] == 256 and rec["mesh"] == "16x16"
    # a serving rank holds its bf16 parameter blocks and cache blocks
    cell = dryrun.build_cell("stablelm-1.6b", shape,
                             make_production_mesh(dry=True))
    assert mem["peak_by_kind"]["parameters"] > 0
    assert mem["peak_by_kind"]["inputs"] > 0
    assert rec["params"] == cell.meta["params"]
    # one flash-attention-free decode: no kernel but the products
    assert rec["flops"] > rec["per_chip_dot_flops"] > 0
    assert rec["collective_calls_per_chip"]


def test_perf_variants_are_the_reference_s(reference):
    """`launch.perf.VARIANTS`, entry for entry: names, rules, config
    overrides and hypotheses."""
    from repro_torch.launch.perf import VARIANTS
    assert _norm(VARIANTS) == reference["variants"]


def test_failed_cell_is_recorded_with_its_error():
    shape = shapes_for("dlrm-m3")["train_b64k"]
    rec = dryrun.run_cell("dlrm-m3", shape, False,
                          config_overrides={"placement": "column_wise"})
    assert rec["ok"] is False
    assert rec["error"] and rec["traceback"]
    assert rec["config_overrides"] == {"placement": "column_wise"}


def test_one_card_fit_halves_the_batch_until_it_fits():
    """stablelm-1.6b's decode_32k on one card: 128 sequences of 32,768
    positions hold 6.4 GB of bf16 cache each, so the global batch halves
    to the largest power of two that fits 80 GB."""
    rec = dryrun.fit_one_card("stablelm-1.6b",
                              shapes_for("stablelm-1.6b")["decode_32k"])
    assert rec["ok"] and rec["fits"], rec.get("traceback")
    batches = [b for b, _ in rec["tried"]]
    assert batches == [128, 64, 32, 16, 8] and rec["batch"] == 8
    peaks = [p for _, p in rec["tried"]]
    assert all(a > b for a, b in zip(peaks, peaks[1:]))
    assert peaks[-1] <= rec["hbm_bytes"] < peaks[-2]
