"""The port's dry-run cells and dry run against the JAX package's.

The reference's cell functions (``repro/configs/families.py``) run in ONE
subprocess under ``--xla_force_host_platform_device_count=256`` on the
(16, 16) production mesh; they build cells and never lower them.  For
eight (arch, shape, variant) cells covering every family and one LM
variant, the port's cells (``repro_torch/configs/families.py``, built on
a `families.MeshShape`) must hold the same input leaves (shapes, dtypes
and placements, the reference's stacked layer axis split into one entry a
layer), the same output placements and donation hints, and the same bytes
per rank (`launch.dryrun.bytes_per_rank` against the reference's
``NamedSharding.shard_shape``).  The dry run's matmul FLOPs of a reduced
GNN cell and a reduced recsys cell must equal counts written out here;
the reference's `parse_collectives` / `effective_wire_bytes` cases
(tests/test_launch.py) run against the port's copies; ``--all`` records
a cell that cannot be counted with an error, never a zero."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import families, registry
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]

CELLS = [("llama3-8b", "train_4k", None),
         ("llama3-8b", "train_4k", "tp_repl"),
         ("qwen3-moe-30b-a3b", "decode_32k", None),
         ("graphcast", "minibatch_lg", None),
         ("dcn-v2", "train_batch", None),
         ("two-tower-retrieval", "retrieval_cand", None),
         ("dien", "serve_p99", None),
         ("remoterag", "module2_b256", None)]

_REFERENCE = textwrap.dedent("""
    import json, math, sys
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import registry
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh()

    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx",
                        getattr(k, "name", k)))) for k in path)

    def entries(spec):
        return [None if e is None else ([e] if isinstance(e, str)
                                        else list(e)) for e in spec]

    out = []
    for arch, shape, variant in json.loads(sys.argv[1]):
        entry = registry.get(arch)
        cell = entry.build_cell(entry.config, entry.shapes[shape], mesh,
                                variant=variant)
        args, total = [], 0
        for arg, sh in zip(cell.args, cell.in_shardings):
            leaves = jax.tree_util.tree_flatten_with_path(arg)[0]
            shs = jax.tree_util.tree_leaves(sh)
            got = []
            for (path, sds), ns in zip(leaves, shs):
                local = ns.shard_shape(sds.shape)
                total += math.prod(local) * sds.dtype.itemsize
                got.append([name(path), list(sds.shape), str(sds.dtype),
                            entries(ns.spec)])
            args.append(got)
        outs = None
        if cell.out_shardings is not None:
            outs = [[name(path), entries(ns.spec)] for path, ns in
                    jax.tree_util.tree_flatten_with_path(
                        cell.out_shardings)[0]]
        out.append(dict(args=args, bytes=total, outs=outs,
                        donate=list(cell.donate_argnums)))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CELLS)],
                         capture_output=True, text=True, env=env, timeout=600,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _full(entries, ndim: int) -> tuple:
    """Spec entries as a tuple of axis tuples, padded to the rank."""
    dims = [tuple(e) if e else () for e in entries]
    return tuple(dims + [()] * (ndim - len(dims)))


def _split(name: str, n_stack: dict) -> list:
    """The port's names of a reference leaf: one a layer for a stacked
    leaf (``layers.attn.wq`` -> ``layers.{i}.attn.wq``), else its own."""
    parts = name.split(".")
    hit = [i for i, p in enumerate(parts)
           if p in n_stack and i + 1 < len(parts)]
    if not hit:
        return [name]
    i = hit[0]
    return [".".join(parts[:i + 1] + [str(layer)] + parts[i + 1:])
            for layer in range(n_stack[parts[i]])]


def _reference_leaves(ref_arg: list, n_stack: dict) -> dict:
    """{port name: (shape, dtype, spec)} of one reference input, its
    stacked leaves split into one entry a layer."""
    out = {}
    for name, shape, dtype, spec in ref_arg:
        spec = _full(spec, len(shape))
        names = _split(name, n_stack)
        if len(names) > 1:
            assert shape[0] == len(names) and spec[0] == (), (name, spec)
            shape, spec = shape[1:], spec[1:]
        out.update({k: (tuple(shape), dtype, spec) for k in names})
    return out


def _port_leaves(arg, specs) -> dict:
    spec_of = dict(dryrun.leaves(specs))
    out = {}
    for path, leaf in dryrun.leaves(arg):
        spec = spec_of[path] if path in spec_of else spec_of[""]
        dtype = str(leaf.dtype).replace("torch.", "")
        out[path] = (tuple(leaf.shape), dtype,
                     _full(spec.dims, leaf.dim()))
    return out


@pytest.mark.parametrize("idx", range(len(CELLS)),
                         ids=["-".join(filter(None, c)) for c in CELLS])
def test_cell_matches_reference(reference_cells, idx):
    arch, shape, variant = CELLS[idx]
    ref = reference_cells[idx]
    mesh = families.production_mesh()
    entry = registry.get(arch)
    cell = entry.build_cell(entry.config, entry.shapes[shape], mesh,
                            variant=variant)
    n_stack = {}
    if entry.family in ("lm", "gnn"):
        n_stack["layers"] = entry.config.n_layers
    if arch == "dcn-v2":
        n_stack["cross"] = entry.config.n_cross_layers
    assert len(cell.args) == len(ref["args"])
    for arg, specs, ref_arg in zip(cell.args, cell.in_shardings,
                                   ref["args"]):
        want = _reference_leaves(ref_arg, n_stack)
        got = _port_leaves(arg, specs)
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
        for k in want:
            assert got[k] == want[k], (k, got[k], want[k])
    assert dryrun.bytes_per_rank(cell, mesh) == ref["bytes"]
    assert list(cell.donate_argnums) == ref["donate"]
    if ref["outs"] is None:
        assert cell.out_shardings is None
    else:
        want = {}
        for name, spec in ref["outs"]:
            names = _split(name, n_stack)
            spec = _full(spec, len(spec))[1 if len(names) > 1 else 0:]
            want.update({k: spec for k in names})
        got = {k: s.dims for k, s in dryrun.leaves(cell.out_shardings)}
        assert got == want


def test_every_cell_builds_on_meta_without_a_device():
    mesh = families.production_mesh()
    built = 0
    for arch in registry.REGISTRY:
        for cell in registry.cells(arch, mesh):
            for arg in cell.args:
                for _, leaf in dryrun.leaves(arg):
                    assert leaf.device.type == "meta"
            assert dryrun.bytes_per_rank(cell, mesh) > 0
            built += 1
    assert built == 42                     # 40 assigned + remoterag's two


def _reduced_cell(arch, shape):
    entry = registry.get(arch)
    return entry.build_cell(entry.reduced, entry.shapes[shape],
                            families.production_mesh())


def test_dryrun_flops_of_a_reduced_gnn_cell():
    """Reduced graphcast (3 layers, d 32, 8 vars) on ``molecule`` (4,096
    nodes, 8,192 edges, d_feat 32): one train step's matrix products,
    2·M·K·N each forward and twice that backward, less the encoder's
    first product's input gradient (the node features need none)."""
    v, e, f, d, out, layers = 4096, 8192, 32, 32, 8, 3
    fwd = 2 * (v * f * d + v * d * d          # encoder
               + e * 2 * d * d                # edge encoder
               + layers * (e * (3 * d * d + d * d) + v * (2 * d * d + d * d))
               + v * d * d + v * d * out)     # decoder
    want = 3 * fwd - 2 * v * f * d
    assert want == 1_004_535_808
    assert dryrun.count_flops(_reduced_cell("graphcast", "molecule")) == want


def test_dryrun_flops_of_a_reduced_recsys_cell():
    """Reduced DCN-v2 (4 dense, 6 x 8 sparse: d_in 52; 2 cross layers;
    deep 32-16; head 68 -> 1) at ``train_batch`` (65,536): forward and
    both backward products of every matrix product."""
    b, d = 65_536, 52
    fwd = 2 * b * (2 * d * d + d * 32 + 32 * 16 + (d + 16) * 1)
    assert 3 * fwd == 3_008_888_832
    assert dryrun.count_flops(_reduced_cell("dcn-v2", "train_batch")) == \
        3 * fwd


def test_module1_mesh_step_equals_one_process(tmp_path):
    """The module-1 cell's collective step (`make_sharded_topk`) on a
    one-rank gloo mesh on the CPU against its one-process ``fn``, on real
    tensors of a small module-1 shape: the same top-k' values within
    1e-5 and the same ids."""
    from repro_torch.configs import shapes
    from repro_torch.launch import mesh as mesh_lib

    shape = shapes.RagShape("m1", "module1", corpus=4096, dim=64, batch=3,
                            kprime=16)
    cell = families.remoterag_cell(
        shape, families.MeshShape((1, 1), ("data", "model")))
    g = torch.Generator().manual_seed(0)
    q = torch.randn((3, 64), generator=g)
    c = torch.nn.functional.normalize(torch.randn((4096, 64), generator=g),
                                      dim=1)
    mesh_lib.init_ranks("gloo", store_path=tmp_path / "store", rank=0,
                        world_size=1, timeout_s=60)
    try:
        live = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cpu",
                                  backend="gloo")
        values, ids = cell.mesh_fn(live)(q, c)
    finally:
        mesh_lib.shutdown()
    want_v, want_i = cell.fn(q, c)
    torch.testing.assert_close(values, want_v, rtol=1e-5, atol=1e-6)
    assert torch.equal(ids.long(), want_i)


HLO_SAMPLE = """
  %ar = f32[16,128]{1,0} all-reduce(f32[16,128]{1,0} %x), replica_groups={}
  %ag.1 = bf16[32,256]{1,0} all-gather(bf16[2,256]{1,0} %y), dimensions={0}
  %rs = f32[4,64]{1,0} reduce-scatter(f32[64,64]{1,0} %z), dimensions={0}
  %cp = s32[8]{0} collective-permute(s32[8]{0} %w)
  %ars = f32[16,16]{1,0} all-reduce-start(f32[16,16]{1,0} %v)
  %nope = f32[2,2]{1,0} add(f32[2,2]{1,0} %a, f32[2,2]{1,0} %b)
"""


def test_collective_parser():
    out = dryrun.parse_collectives(HLO_SAMPLE)
    assert out["all-reduce"]["count"] == 2
    assert out["all-reduce"]["result_bytes"] == 16 * 128 * 4 + 16 * 16 * 4
    assert out["all-gather"]["result_bytes"] == 32 * 256 * 2
    assert out["reduce-scatter"]["result_bytes"] == 4 * 64 * 4
    assert out["collective-permute"]["result_bytes"] == 8 * 4
    assert dryrun.effective_wire_bytes(out, 16) > 0


def test_effective_wire_ring_model():
    coll = {"all-reduce": {"count": 1, "result_bytes": 1000}}
    assert dryrun.effective_wire_bytes(coll, 16) == pytest.approx(
        2 * 1000 * 15 / 16)


def test_dryrun_records_an_uncounted_cell_as_an_error(tmp_path):
    """FM's step has no matmul-class op and module 2 is integer NTT work:
    their records carry an error and a null count, never 0."""
    for arch, shape in (("fm", "serve_p99"), ("remoterag", "module2_b256")):
        dryrun.main(["--arch", arch, "--shape", shape, "--out",
                     str(tmp_path)])
        rec = json.loads((tmp_path / f"{arch}__{shape}__pod.json")
                         .read_text())
        assert rec["ok"] and rec["matmul_flops"] is None
        assert "FLOPs not counted" in rec["error"]
        assert rec["bytes_per_device"] > 0 and rec["fits_hbm"]
    dryrun.main(["--arch", "two-tower-retrieval", "--shape",
                 "retrieval_cand", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "two-tower-retrieval__retrieval_cand__pod"
                      ".json").read_text())
    # 1 user x 10^6 (padded to 1,000,192) candidates x 256, plus the tower
    assert rec["ok"] and "error" not in rec
    assert rec["matmul_flops"] == 2 * 1_000_192 * 256 + 2 * (
        8 * 256 * 1024 + 1024 * 512 + 512 * 256)
