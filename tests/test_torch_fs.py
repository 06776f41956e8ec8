"""Remote file schemes in the data feed, in both packages.

The port's ``data_feed.open_file`` reads a scheme-prefixed path through
the filesystem registered for its scheme (``io/fs.py``), as the JAX
package's does.  Copies of ``tests/test_fs.py``'s
``test_dataset_reads_remote_scheme`` (a ShellFS whose "remote" is a local
staging directory driven purely through shell commands — the hadoop
pattern, no hadoop) and ``test_unknown_scheme_raises``, run on each
package, plus the refusal of a ``pipe_command`` over a remote path and a
gzipped remote file.
"""

import gzip
import subprocess
import types

import pytest

from paddlebox_tpu.config import DataFeedConfig as JFeed
from paddlebox_tpu.config import SlotConfig as JSlot
from paddlebox_tpu.data import data_feed as jdata_feed
from paddlebox_tpu.io import fs as jfs
from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.data import data_feed
from paddlebox_tpu_torch.io import fs as tfs

PKGS = {
    "jax": types.SimpleNamespace(fs=jfs, data_feed=jdata_feed, Feed=JFeed,
                                 Slot=JSlot),
    "torch": types.SimpleNamespace(fs=tfs, data_feed=data_feed,
                                   Feed=DataFeedConfig, Slot=SlotConfig),
}
LINES = ["1 1 1 7 2 0.5 0.5", "1 0 2 8 9 2 0.1 0.2"]


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def fake_remote(tmp_path, pkg):
    """A ShellFS over ``fake://`` on ``pkg``'s registry."""
    root = tmp_path / "remote"
    root.mkdir()

    def strip(p):
        return str(root / p.replace("fake://", "").lstrip("/"))

    class FakeShell(pkg.fs.ShellFS):
        def _run(self, tmpl, path, **kw):
            cmd = tmpl.format(path=f"'{strip(path)}'")
            return subprocess.Popen(cmd, shell=True, **kw)

    pkg.fs.register_fs("fake", FakeShell(
        cat_cmd="cat {path}",
        put_cmd="mkdir -p $(dirname {path}) && cat > {path}",
        ls_cmd="ls -d {path}/* 2>/dev/null",
        mkdir_cmd="mkdir -p {path}",
        exists_cmd="test -e {path}",
        remove_cmd="rm -rf {path}"))
    yield root
    pkg.fs._REGISTRY.pop("fake", None)


def _cfg(pkg, pipe_command=""):
    return pkg.Feed(slots=(
        pkg.Slot("label", dtype="float", is_dense=True, dim=1),
        pkg.Slot("s0", slot_id=100, capacity=2),
        pkg.Slot("dense0", dtype="float", is_dense=True, dim=2),
    ), pipe_command=pipe_command)


@pytest.mark.parametrize("name,payload", [
    ("pass-0.txt", lambda b: b),
    ("pass-0.txt.gz", gzip.compress)], ids=["text", "gz"])
def test_dataset_reads_remote_scheme(fake_remote, pkg, name, payload):
    pkg.fs.get_fs("fake://x").write_bytes(
        f"fake://data/{name}",
        payload(("\n".join(LINES) + "\n").encode()))
    feed = pkg.data_feed.DataFeed(_cfg(pkg))
    blocks = list(feed.read_file(f"fake://data/{name}"))
    assert sum(b.n for b in blocks) == 2
    vals, offs = blocks[0].uint64_slots["s0"]
    assert vals.tolist() == [7, 8, 9]
    assert offs.tolist() == [0, 1, 3]


def test_pipe_command_over_remote_path_refused(fake_remote, pkg):
    pkg.fs.get_fs("fake://x").write_bytes("fake://data/p.txt", b"1 1 1 7\n")
    with pytest.raises(ValueError, match="pipe_command over a remote path"):
        pkg.data_feed.open_file("fake://data/p.txt", pipe_command="cat")


def test_unknown_scheme_raises(pkg):
    with pytest.raises(ValueError, match="no filesystem registered"):
        pkg.fs.get_fs("s3://bucket/x")
    feed = pkg.data_feed.DataFeed(_cfg(pkg))
    with pytest.raises(ValueError, match="no filesystem registered"):
        list(feed.read_file("s3://bucket/pass-0.txt"))
