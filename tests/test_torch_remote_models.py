"""The port's S3 and HDFS model stores held against the JAX package's, on
the CPU.

The tests need no object store, no Hadoop and no boto3. A small in-memory
``boto3`` double (one bucket dictionary, ``put_object``, ``get_object``,
``delete_object``, ``list_objects_v2`` with pages) stands in for S3, and
pyarrow's ``HadoopFileSystem`` is replaced by a ``SubTreeFileSystem``
over a temporary directory, so that both packages' real stores run. The
resilience cases of ``tests/test_resilience.py`` run on the port's
``_ResilientCalls`` at the ``models.s3`` and ``models.hdfs`` fault sites;
then each store's round trip, its digest objects, a corrupt or torn blob
refused, a blob either package writes read by the other, faults retried
through the breaker, the registry's S3 and HDFS types with each
repository on its own source's settings, and a missing client library
named.
"""

import sys
import types

import pytest

from predictionio_tpu.storage import remote as jax_remote
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage import remote as port_remote
from predictionio_tpu_torch.storage.remote import (
    HDFSModelStore,
    S3ModelStore,
    StorageClientError,
    _ResilientCalls,
)
from predictionio_tpu_torch.utils.faults import FAULTS, FaultError
from predictionio_tpu_torch.utils.integrity import IntegrityError
from predictionio_tpu_torch.utils.resilience import CLOSED, OPEN, CircuitOpenError

REMOTE = {"jax": jax_remote, "port": port_remote}


class _FakeRemoteStore(_ResilientCalls):
    """The retry, breaker and fault plumbing of the model stores without a
    client library: the real ``models.s3`` and ``models.hdfs`` sites."""

    def __init__(self, kind):
        self._init_resilience(kind, retries=2)


class TestRemoteStoreResilience:
    @pytest.mark.parametrize("kind,site", [("s3", "models.s3"), ("hdfs", "models.hdfs")])
    def test_injected_outage_is_retried_through_the_breaker(self, kind, site):
        store = _FakeRemoteStore(kind)
        store.breaker.reset()  # breakers are shared per backend kind
        try:
            FAULTS.arm(site, error=f"{kind} down", count=1)
            assert store._call(lambda: "blob") == "blob"  # one failure, then the retry
            assert store.breaker.state == CLOSED
            FAULTS.arm(site, error=f"{kind} down")
            with pytest.raises(FaultError):
                store._call(lambda: "blob")
        finally:
            FAULTS.disarm()
            store.breaker.reset()

    def test_botocore_shaped_retry_after_is_attached(self):
        e = RuntimeError("throttled")
        e.response = {"ResponseMetadata": {"HTTPHeaders": {"retry-after": "0.2"}}}
        _ResilientCalls._attach_retry_hint(e)
        assert e.retry_after == 0.2
        e.response["ResponseMetadata"]["HTTPHeaders"]["retry-after"] = "9"
        _ResilientCalls._attach_retry_hint(e)  # an existing hint stays
        assert e.retry_after == 0.2

    def test_hintless_errors_are_left_alone(self):
        e = RuntimeError("plain")
        _ResilientCalls._attach_retry_hint(e)
        assert getattr(e, "retry_after", None) is None


# -- an in-memory S3 ------------------------------------------------------------------


class _NoSuchKey(Exception):
    pass


class _Body:
    def __init__(self, data):
        self._data = data

    def read(self):
        return self._data


class _FakeS3Client:
    exceptions = types.SimpleNamespace(NoSuchKey=_NoSuchKey)

    def __init__(self, buckets, page=2):
        self.buckets, self.page, self.calls = buckets, page, []

    def put_object(self, Bucket, Key, Body):
        self.calls.append("put")
        self.buckets.setdefault(Bucket, {})[Key] = bytes(Body)

    def get_object(self, Bucket, Key):
        self.calls.append("get")
        try:
            return {"Body": _Body(self.buckets.get(Bucket, {})[Key])}
        except KeyError:
            raise _NoSuchKey(Key) from None

    def delete_object(self, Bucket, Key):
        self.calls.append("delete")
        self.buckets.get(Bucket, {}).pop(Key, None)

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        self.calls.append("list")
        keys = sorted(k for k in self.buckets.get(Bucket, {}) if k.startswith(Prefix))
        start = int(ContinuationToken or 0)
        page = keys[start:start + self.page]
        out = {"Contents": [{"Key": k} for k in page],
               "IsTruncated": start + self.page < len(keys)}
        if out["IsTruncated"]:
            out["NextContinuationToken"] = str(start + self.page)
        return out


@pytest.fixture
def s3(monkeypatch):
    """The buckets of one fake S3, shared by both packages' clients."""
    buckets = {}
    mod = types.ModuleType("boto3")
    mod.client = lambda service: _FakeS3Client(buckets)
    monkeypatch.setitem(sys.modules, "boto3", mod)
    for m in REMOTE.values():
        m._ResilientCalls._breakers.pop("s3", None)
    return buckets


@pytest.fixture
def hdfs(monkeypatch, tmp_path):
    """pyarrow's HadoopFileSystem as a directory: (root dir, connects)."""
    from pyarrow import fs

    root = tmp_path / "hdfs"
    root.mkdir()
    connects = []

    def hadoop(host, port):
        connects.append((host, port))
        return fs.SubTreeFileSystem(str(root), fs.LocalFileSystem())

    monkeypatch.setattr(fs, "HadoopFileSystem", hadoop)
    for m in REMOTE.values():
        m._ResilientCalls._breakers.pop("hdfs", None)
    return root, connects


def s3_store(pkg, **kw):
    return REMOTE[pkg].S3ModelStore(bucket="models", base_path="pio/m", **kw)


def hdfs_store(pkg):
    return REMOTE[pkg].HDFSModelStore(host="nn", port=9000, path="/pio_models")


STORES = {"s3": s3_store, "hdfs": hdfs_store}


@pytest.mark.parametrize("kind", ["s3", "hdfs"])
def test_round_trip_with_digest_objects(kind, request):
    request.getfixturevalue(kind)
    st = STORES[kind]("port")
    blob = bytes(range(256)) * 9
    st.put("i1", blob)
    st.put("i2", b"\x00")
    st.put("i3", b"three")
    assert st.get("i1") == blob and st.get("missing") is None
    assert sorted(st.list_ids()) == ["i1", "i2", "i3"]  # S3 lists in pages of 2
    assert st.delete("i2") and sorted(st.list_ids()) == ["i1", "i3"]
    assert st.get("i2") is None
    assert st.breaker.state == CLOSED


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind", ["s3", "hdfs"])
def test_a_blob_one_package_wrote_the_other_reads(kind, writer, reader, request):
    state = request.getfixturevalue(kind)
    blob = bytes(range(256)) * 33
    STORES[kind](writer).put("inst", blob)
    r = STORES[kind](reader)
    assert r.get("inst") == blob and r.list_ids() == ["inst"]
    if kind == "s3":
        assert sorted(state["models"]) == ["pio/m/inst.bin", "pio/m/inst.bin.sha256"]
    else:
        assert sorted(p.name for p in (state[0] / "pio_models").iterdir()) == \
            ["inst.bin", "inst.bin.sha256"]


@pytest.mark.parametrize("kind", ["s3", "hdfs"])
def test_a_corrupt_or_torn_blob_is_refused(kind, request):
    state = request.getfixturevalue(kind)
    st = STORES[kind]("port")
    st.put("good", b"a" * 100)
    st.put("bad", b"b" * 100)
    if kind == "s3":
        state["models"]["pio/m/bad.bin"] = b"c" * 100  # the digest no longer matches
        del state["models"]["pio/m/good.bin.sha256"]  # a blob from before digests
    else:
        (state[0] / "pio_models" / "bad.bin").write_bytes(b"c" * 100)
        (state[0] / "pio_models" / "good.bin.sha256").unlink()
    with pytest.raises(IntegrityError):
        st.get("bad")
    assert st.get("good") == b"a" * 100
    st.put("x", b"xyz" * 10)
    try:
        FAULTS.arm("data.corrupt.model")  # a byte flipped on the way down
        with pytest.raises(IntegrityError):
            st.get("x")
    finally:
        FAULTS.disarm()


@pytest.mark.parametrize("kind", ["s3", "hdfs"])
def test_faults_are_retried_then_trip_the_breaker(kind, request):
    request.getfixturevalue(kind)
    st = STORES[kind]("port")
    st.put("m", b"blob")
    site = f"models.{kind}"
    try:
        FAULTS.arm(site, error="down", count=2)  # the retries outlast it
        assert st.get("m") == b"blob"
        FAULTS.arm(site, error="down")
        with pytest.raises(FaultError):
            st.get("m")
        with pytest.raises((FaultError, CircuitOpenError)):
            st.get("m")
        assert st.breaker.state == OPEN
        with pytest.raises(CircuitOpenError):  # fails fast, touches nothing
            st.list_ids()
    finally:
        FAULTS.disarm()
        st.breaker.reset()


def test_registry_opens_s3_and_hdfs_with_their_own_sources(s3, hdfs, tmp_path):
    cfg = port_registry.StorageConfig.from_env({
        "PIO_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3HOT",
        "PIO_STORAGE_SOURCES_S3COLD_TYPE": "S3",
        "PIO_STORAGE_SOURCES_S3COLD_BUCKET_NAME": "archive",
        "PIO_STORAGE_SOURCES_S3HOT_TYPE": "s3",
        "PIO_STORAGE_SOURCES_S3HOT_BUCKET_NAME": "serving",
        "PIO_STORAGE_SOURCES_S3HOT_BASE_PATH": "/engines/",
    })
    assert cfg.modeldata_type == "S3"
    assert cfg.source_properties("MODELDATA")["BUCKET_NAME"] == "serving"
    st = port_registry.Storage(cfg)
    assert isinstance(st.models, S3ModelStore) and st.verify()["modeldata"] == "S3"
    st.models.put("x", b"1")
    assert sorted(s3) == ["serving"] and "engines/x.bin" in s3["serving"]
    cfg = port_registry.StorageConfig.from_env({
        "PIO_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "HD",
        "PIO_STORAGE_SOURCES_HD_TYPE": "HDFS",
        "PIO_STORAGE_SOURCES_HD_HOSTS": "namenode",
        "PIO_STORAGE_SOURCES_HD_PORTS": "8021",
        "PIO_STORAGE_SOURCES_HD_PATH": "/models",
    })
    st = port_registry.Storage(cfg)
    assert isinstance(st.models, HDFSModelStore) and st.verify()["modeldata"] == "HDFS"
    st.models.put("y", b"2")
    assert hdfs[1] == [("namenode", 8021)]
    assert (hdfs[0] / "models" / "y.bin").read_bytes() == b"2"


def test_missing_client_libraries_are_named(monkeypatch, tmp_path):
    from pyarrow import fs

    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(StorageClientError, match="boto3"):
        S3ModelStore(bucket="b")
    st = port_registry.Storage(port_registry.StorageConfig(
        home=str(tmp_path), modeldata_type="S3"))
    with pytest.raises(StorageClientError, match="boto3"):
        _ = st.models
    monkeypatch.setitem(sys.modules, "boto3", types.ModuleType("boto3"))
    with pytest.raises(StorageClientError, match="BUCKET_NAME"):
        S3ModelStore(props={})

    def unreachable(host, port):
        raise OSError("libhdfs not found")

    monkeypatch.setattr(fs, "HadoopFileSystem", unreachable)
    with pytest.raises(StorageClientError, match="cannot reach HDFS at nn:9000"):
        HDFSModelStore(host="nn", port=9000)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(StorageClientError, match="pyarrow"):
        HDFSModelStore(host="nn", port=9000)
    assert list(tmp_path.iterdir()) == []  # nothing fell back to LOCALFS


@pytest.mark.parametrize("kind", ["s3", "hdfs"])
def test_get_storage_opens_the_type_from_the_environment(kind, request, monkeypatch,
                                                         tmp_path):
    request.getfixturevalue(kind)
    env = {"PIO_HOME": str(tmp_path), "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
           "PIO_STORAGE_SOURCES_M_TYPE": kind.upper()}
    env.update({"PIO_STORAGE_SOURCES_M_BUCKET_NAME": "b"} if kind == "s3" else
               {"PIO_STORAGE_SOURCES_M_HOSTS": "nn", "PIO_STORAGE_SOURCES_M_PATH": "/m"})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port_registry.set_storage(None)
    try:
        st = port_registry.get_storage()
        assert st.config.modeldata_type == kind.upper()
        assert isinstance(st.models, S3ModelStore if kind == "s3" else HDFSModelStore)
        st.models.put("inst", b"blob")
        assert st.models.get("inst") == b"blob" and st.verify()["modeldata"] == kind.upper()
    finally:
        port_registry.set_storage(None)
