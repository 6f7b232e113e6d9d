"""``pio batchpredict`` in the port held against the JAX package's, on the CPU.

Twin temporary homes are seeded alike (``tests/test_workflow.seed_ratings``)
and hold one JAX-trained Recommendation instance each, trained the same
way. On them:

- ``core/batchpredict.run_batch_predict`` over the port's deploy of the
  instance writes the JAX function's JSONL line for line (``{"query",
  "prediction"}``, the same separators), in batches of any size, a last
  partial batch, rating-shaped queries and unknown users included;
- on the device path (``PIO_ALS_SERVE=device``; a CPU tensor takes the
  kernel's plain version) each batch is ONE scoring dispatch and every
  line equals the host path's up to near-ties within 1e-5;
- ``shards > 1`` (the JAX package's item-sharded ANN mesh) is refused
  with a clear error; 0 and 1 run;
- the CLI verb ``batchpredict`` (``--engine-dir``, ``-e``, ``--input``,
  ``--output``, ``--engine-instance-id``, ``--batch-size``, ``--shards``,
  ``--device cpu``) prints the JAX CLI's line and writes its file.
"""

import io
import json
import os

import pytest

from predictionio_tpu.core.batchpredict import run_batch_predict as jax_run_batch_predict
from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.core.batchpredict import run_batch_predict
from predictionio_tpu_torch.core.workflow import prepare_deploy
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.tools import cli
from tests.test_torch_templates import same_answers
from tests.test_workflow import FACTORY, VARIANT, seed_ratings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ([{"user": str(u), "num": 1 + u % 7} for u in range(30)]
           + [{"user": "nobody", "num": 3}, {"user": "4", "item": "3"},
              {"user": "5", "num": 25}, {"user": "6"}])


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    """{"jax": (home, instance id), "port": (home, instance id)}: twin
    homes, each with the same JAX-trained instance."""
    out = {}
    for name in ("jax", "port"):
        home = str(tmp_path_factory.mktemp(f"pio_bp_{name}"))
        st = JaxStorage(JaxStorageConfig(home=home))
        seed_ratings(st)
        out[name] = (home, jax_run_train(FACTORY, variant=VARIANT, storage=st,
                                         use_mesh=False))
    return out


def _src(queries=QUERIES):
    return io.StringIO("".join(json.dumps(q) + "\n" for q in queries) + "\n")


def _port_deployed(home, iid):
    return prepare_deploy(instance_id=iid, storage=Storage(StorageConfig(home=home)),
                          device="cpu")


@pytest.mark.parametrize("batch_size", [1, 7, 1024])
def test_lines_equal_the_jax_functions(homes, batch_size):
    jhome, jid = homes["jax"]
    phome, pid = homes["port"]
    want, got = io.StringIO(), io.StringIO()
    n_j = jax_run_batch_predict(
        jax_prepare_deploy(instance_id=jid, storage=JaxStorage(JaxStorageConfig(home=jhome))),
        _src(), want, batch_size=batch_size)
    n_p = run_batch_predict(_port_deployed(phome, pid), _src(), got, batch_size=batch_size)
    assert n_p == n_j == len(QUERIES)
    assert got.getvalue().splitlines() == want.getvalue().splitlines()
    lines = [json.loads(ln) for ln in got.getvalue().splitlines()]
    assert [ln["query"] for ln in lines] == QUERIES
    assert lines[30]["prediction"] == {"itemScores": []}


def test_the_device_path_scores_a_batch_in_one_dispatch(homes, monkeypatch):
    phome, pid = homes["port"]
    host = io.StringIO()
    run_batch_predict(_port_deployed(phome, pid), _src(), host, batch_size=8)
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    calls = []
    real = port_als.ResidentScorer.recommend_batch

    def counting(self, user_ids, num, exclude=None):
        calls.append((len(user_ids), num))
        return real(self, user_ids, num, exclude)

    monkeypatch.setattr(port_als.ResidentScorer, "recommend_batch", counting)
    dev = io.StringIO()
    run_batch_predict(_port_deployed(phome, pid), _src(), dev, batch_size=8)
    # five batches of 8 and 2; the rating-shaped query and the unknown
    # user are answered without the device
    assert [b for b, _ in calls] == [8, 8, 8, 6, 2]
    assert [k for _, k in calls] == [7, 7, 7, 7, 25]
    for a, b in zip(dev.getvalue().splitlines(), host.getvalue().splitlines()):
        a, b = json.loads(a), json.loads(b)
        assert a["query"] == b["query"]
        assert same_answers(a["prediction"], b["prediction"]), (a, b)


@pytest.mark.parametrize("shards", [0, 1])
def test_shards_zero_and_one_run(homes, shards):
    phome, pid = homes["port"]
    out = io.StringIO()
    assert run_batch_predict(_port_deployed(phome, pid), _src(), out, shards=shards) \
        == len(QUERIES)


def test_sharded_retrieval_is_refused(homes):
    phome, pid = homes["port"]
    with pytest.raises(ValueError, match="not ported"):
        run_batch_predict(_port_deployed(phome, pid), _src(), io.StringIO(), shards=4)


def _cli(main, registry, storage, argv, capsys):
    registry.set_storage(storage)
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        registry.set_storage(None)
    out = capsys.readouterr()
    return code, out.out.splitlines()


def test_cli_batchpredict_matches_the_jax_verb(homes, tmp_path, capsys):
    src = tmp_path / "queries.jsonl"
    src.write_text("".join(json.dumps(q) + "\n" for q in QUERIES))
    outs = {}
    for name, main, registry, storage, engine_dir, extra in (
            ("jax", jax_cli.main, jax_registry, JaxStorage(JaxStorageConfig(
                home=homes["jax"][0])), "predictionio_tpu", []),
            ("port", cli.main, port_registry, Storage(StorageConfig(
                home=homes["port"][0])), "predictionio_tpu_torch", ["--device", "cpu"])):
        dst = tmp_path / f"{name}.jsonl"
        code, lines = _cli(main, registry, storage, [
            "batchpredict", "--engine-dir",
            os.path.join(REPO, engine_dir, "templates", "recommendation"),
            "--input", str(src), "--output", str(dst), "--batch-size", "5",
            "--engine-instance-id", homes[name][1]] + extra, capsys)
        assert code == 0
        outs[name] = (lines, dst.read_text())
    jlines, jtext = outs["jax"]
    plines, ptext = outs["port"]
    assert ptext.splitlines() == jtext.splitlines()
    assert plines[0].replace(str(tmp_path / "port"), "") == \
        jlines[0].replace(str(tmp_path / "jax"), "")
    assert plines[1].startswith("[info] kernel launches: score_topk=0")


def test_cli_batchpredict_flags():
    args = cli.build_parser().parse_args([
        "batchpredict", "--engine-dir", "d", "-e", "v.json", "--input", "in.jsonl",
        "--output", "out.jsonl", "--engine-instance-id", "X", "--batch-size", "64",
        "--shards", "1", "--device", "cpu"])
    assert (args.engine_dir, args.variant, args.input, args.output,
            args.engine_instance_id, args.batch_size, args.shards, args.device) == (
        "d", "v.json", "in.jsonl", "out.jsonl", "X", 64, 1, "cpu")
    args = cli.build_parser().parse_args(["batchpredict", "--input", "i", "--output", "o"])
    assert (args.batch_size, args.shards, args.device) == (1024, 0, None)
