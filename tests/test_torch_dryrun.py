"""``python -m repro_torch.launch.dryrun`` on the CPU: ``run_one`` on the
reduced configs writes the reference's keys for each shape kind, the CLI
exits 1 and lists the failures, an inference batch is split over the
machine axis and "model" where it divides, and glm4-9b's full
``train_4k`` traces at the production mesh (data 32, model 8) with the
payload dims over "model"."""
import json

import pytest

from repro.launch import roofline as jroofline
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, roofline
from torch_threads import share_the_cores  # noqa: F401 (autouse)

#: the reference's JSON keys that mean the same in the port's
KEYS = {"arch", "shape", "mesh", "chips", "agg", "strategy", "kind",
        "sliding_window", "flops_per_device", "bytes_per_device",
        "collective_bytes", "compute_s", "memory_s", "collective_s",
        "dominant", "model_flops", "useful_ratio", "peak_memory_bytes",
        "compile_s", "variant"}


@pytest.fixture
def reduced(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, reduced=True))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_run_one_writes_the_reference_keys(reduced, tmp_path, capsys,
                                           shape):
    arch = "zamba2-7b" if shape == "long_500k" else "glm4-9b"
    meta = dryrun.run_one(arch, shape, False, str(tmp_path), "dcq",
                          "replicated")
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == \
        [f"{arch}_{shape}_32x8_dcq_replicated.json"]
    rec = json.loads(files[0].read_text())
    assert KEYS <= set(rec)
    assert set(dataclass_fields()) <= set(rec)
    assert rec["chips"] == 256 and rec["kind"] == SHAPES[shape].kind
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["peak_memory_bytes"] > 0 and rec["flops_per_device"] > 0
    assert rec["collective_s"] == pytest.approx(
        rec["collective_nvlink_s"] + rec["collective_ib_s"])
    if SHAPES[shape].kind == "train":
        assert rec["launches"]["ostat"] > 0
        assert rec["collective_bytes"]["ib"] > 0
    if SHAPES[shape].kind == "decode":
        assert rec["launches"]["gqa_decode"] > 0
    assert meta["mesh"] == "32x8"
    out = capsys.readouterr().out
    assert f"[dryrun] {arch}_{shape}_32x8_dcq_replicated: OK" in out
    assert "dominant=" in out and "peak_mem=" in out


def dataclass_fields():
    import dataclasses
    return [f.name for f in dataclasses.fields(jroofline.RooflineReport)]


def test_cli_lists_failures_and_exits_1(reduced, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "prefill_32k",
                     "--outdir", str(tmp_path)])
    assert e.value.code == 1
    assert "FAILURES:" in capsys.readouterr().out
    dryrun.main(["--arch", "glm4-9b", "--shape", "decode_32k",
                 "--multi-pod", "--outdir", str(tmp_path)])
    assert "all dry-runs OK" in capsys.readouterr().out
    assert [f.name for f in tmp_path.glob("*.json")] == \
        ["glm4-9b_decode_32k_2x32x8_dcq_replicated.json"]
    # the reference's flags with no counterpart (the module docstring)
    for flag in ("--fsdp", "--kv-mode=seq", "--skip-probes"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "glm4-9b", flag])
        assert e.value.code == 2


@pytest.mark.parametrize("arch,shape,mesh,rows", [
    ("glm4-9b", "prefill_32k", {"data": 32, "model": 8}, 1),
    ("glm4-9b", "prefill_32k", {"data": 4, "model": 2}, 4),
    ("glm4-9b", "prefill_32k", {"pod": 2, "data": 4, "model": 2}, 2),
    ("glm4-9b", "decode_32k", {"data": 32, "model": 8}, 4),
    ("glm4-9b", "decode_32k", {"data": 2, "model": 8}, 8),
    ("zamba2-7b", "long_500k", {"data": 32, "model": 8}, 1),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k", {"data": 4, "model": 2}, 8),
])
def test_inference_rows_split_where_they_divide(reduced, arch, shape, mesh,
                                                rows):
    """An inference batch's rows on a rank: the machine axis's block where
    they divide, then "model"'s where they divide and the family allows
    (not the MoE), replicated otherwise (long_500k's one row)."""
    *_, meta = dryrun.trace_one(arch, shape, mesh=mesh)
    assert meta["rows_per_device"] == rows


def test_full_glm4_train_4k_traces_at_the_production_mesh():
    counts, cfg, shape, meta = dryrun.trace_one("glm4-9b", "train_4k")
    assert meta["mesh"] == "32x8" and meta["chips"] == 256
    assert meta["launches"] == {"ostat": 12}
    rep = roofline.analyze(counts, cfg, shape, meta["mesh"], 256, "glm4-9b")
    coll = counts.collective_bytes()
    # each rank gathers every layer's weights over "model" (its 1/8
    # slices, bf16) in the forward and again in the rematerialised
    # backward, and reduce-scatters their gradients
    n = roofline.count_params(cfg)["total"]
    assert 2 * 2 * n * 7 / 8 < coll["nvlink"] < 4 * 2 * n
    assert coll["reduce-scatter"] > 0 and coll["ib"] > 0
    # one row of 4,096 tokens a rank: 6ND / 256 plus attention and the
    # recomputed forward
    assert 1.0 < rep.flops_per_device / (rep.model_flops / 256) < 1.6
    assert rep.peak_memory_bytes > 2 * n / 8
