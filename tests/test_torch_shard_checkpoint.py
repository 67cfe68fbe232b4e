"""Checkpoints of a sharded state (`train/checkpoint.py` over
`parallel/fsdp.py`): two spawned Gloo ranks under `{data: 2}` with FSDP and
four under `{data: 2, model: 2}` with FSDP each take one AdamW step and
save.  Rank 0 writes the file a one-process run writes (the same keys and
shapes, full tensors, the optimizer's state keyed in the unsharded order),
and the FSDP file restores bitwise into FSDP (2 ranks), into one process and
into `{model: 2}` (2 ranks): each layout puts back together exactly the
file's tensors, and each rank holds exactly its slices of them.  The
four-rank file restores bitwise into one process."""

import os

import pytest
import torch

import torch_ddp
import torch_shard_cases as cases
from test_torch_ddp_step import _batch

ADAMW = cases.training(opt="AdamW", clip=1.0)


def _load(work_dir):
    return torch.load(os.path.join(work_dir, "checkpoints", "latest"), weights_only=True)


def _equal(a, b, where=""):
    """Nested dicts / lists of tensors equal bitwise (the same bytes)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.view(torch.uint8) if a.dim() else a.reshape(1).view(torch.uint8),
                           b.view(torch.uint8) if b.dim() else b.reshape(1).view(torch.uint8)), \
            where
    else:
        assert a == b, where


def _shapes(x):
    if isinstance(x, dict):
        return {k: _shapes(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_shapes(v) for v in x]
    return (tuple(x.shape), x.dtype) if torch.is_tensor(x) else x


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    cfg = cases.vit()
    _, _, _, _, state_dict = cases.weights(cfg, seed=3)
    batch = _batch(8, cases.HW, True, 5)
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("fsdp", "mix", "one")}
    save = {"fsdp": ({"data": 2}, True, 2), "mix": ({"data": 2, "model": 2}, True, 4)}
    ranks = {k: torch_ddp.start({"save": cases.payload(cfg, state_dict, mesh, fsdp, [batch],
                                                       train=ADAMW, save_to=dirs[k])},
                                world=world)
             for k, (mesh, fsdp, world) in save.items()}
    torch_ddp.sharded_steps(0, 1, cases.payload(cfg, state_dict, {}, False, [batch], train=ADAMW,
                                                save_to=dirs["one"]))
    for r in ranks.values():
        r.join()
    restore = lambda mesh, fsdp, path: dict(cases.payload(cfg, state_dict, mesh, fsdp, [],
                                                          train=ADAMW),
                                            task="restore_sharded", path=path)
    into = {"fsdp": ({"data": 2}, True), "tp": ({"model": 2}, False)}
    started = {k: torch_ddp.start({"restore": restore(mesh, fsdp, dirs["fsdp"])}, world=2)
               for k, (mesh, fsdp) in into.items()}
    restored = {"one": torch_ddp.restore_sharded(0, 1, restore({}, False, dirs["fsdp"])),
                "mix_into_one": torch_ddp.restore_sharded(0, 1, restore({}, False, dirs["mix"]))}
    for k, r in started.items():
        restored[k] = [x["restore"] for x in r.join()]
    return {k: _load(d) for k, d in dirs.items()}, restored


@pytest.mark.parametrize("layout", ["fsdp", "mix"])
def test_a_sharded_save_is_a_one_process_file(files, layout):
    saved, _ = files
    assert _shapes(saved[layout]) == _shapes(saved["one"])
    assert saved[layout]["optimizer"]["inner"]["param_groups"] == \
        saved["one"]["optimizer"]["inner"]["param_groups"]
    assert saved[layout]["optimizer"]["count"] == 1 and saved[layout]["step"] == 1


@pytest.mark.parametrize("into", ["fsdp", "one", "tp"])
def test_the_fsdp_file_restores_bitwise(files, into):
    saved, restored = files
    file = saved["fsdp"]
    for got in (restored[into] if isinstance(restored[into], list) else [restored[into]]):
        _equal(got["model"], file["model"], "model")
        _equal(got["optimizer"], file["optimizer"], "optimizer")
        assert got["step"] == 1 and got["epoch"] == 0


def test_each_rank_holds_its_slices_of_the_file(files):
    """Under FSDP a rank's data-sharded tensors are its half of the file's
    (bitwise), and under {model: 2} the qkv weight holds its heads' rows."""
    saved, restored = files
    file = saved["fsdp"]["model"]
    # [512, 128]: JAX's [2, 128, 512] leaf puts its 512 on data, the port's dim 0
    name = "backbone.transformer.blocks.0.mlp.c_fc.weight"
    for rank, got in enumerate(restored["fsdp"]):
        _equal(got["local"][name], file[name][rank * 256:(rank + 1) * 256], name)
    qkv = "backbone.transformer.blocks.0.attn.qkv.weight"  # [384, 128], 4 heads of 32
    for rank, got in enumerate(restored["tp"]):
        rows = torch.cat([file[qkv][p * 128 + rank * 64:p * 128 + (rank + 1) * 64]
                          for p in range(3)])
        _equal(got["local"][qkv], rows, qkv)


def test_the_four_rank_file_restores_bitwise_into_one_process(files):
    saved, restored = files
    got = restored["mix_into_one"]
    _equal(got["model"], saved["mix"]["model"], "model")
    _equal(got["optimizer"], saved["mix"]["optimizer"], "optimizer")
