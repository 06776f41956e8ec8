"""Pluggable filesystem layer — local / AFS / HDFS behind one surface.

≙ the reference's fs abstraction (framework/io/fs.{h,cc}: localfs_* +
hdfs_* verbs dispatched by path prefix, with hdfs access running through
shell commands) and BoxWrapper's AFS wrapper (box_wrapper.h:721-743
dataset_name/afs path plumbing).  Model dumps, checkpoints and dataset
reads route through ``get_fs(path)`` so a job can point save_base/load at
``hdfs://...`` (or any scheme with a registered command set) without code
changes.

The remote flavor shells out exactly like the reference's hdfs_cat /
hdfs_put (fs.cc): reads stream via the configured cat command, writes pipe
through put — no client library dependency in a zero-egress image.
"""

from __future__ import annotations

import io
import os
import shlex
import subprocess
from typing import Dict, Iterator, List, Optional


class FileSystem:
    """Minimal verb set the framework needs (≙ fs.h's *_open_read/write,
    exists, list, mkdir, remove)."""

    def open_read(self, path: str) -> io.BufferedIOBase:
        raise NotImplementedError

    def open_write(self, path: str) -> io.BufferedIOBase:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def ls(self, path: str) -> List[str]:
        raise NotImplementedError

    def mkdir(self, path: str) -> None:
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Atomic-where-possible move (the write-to-tmp-then-rename commit
        step of host_table.save).  Schemes without a move verb raise
        NotImplementedError and callers fall back to direct writes."""
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        with self.open_read(path) as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        # atomic publish is the caller's commit protocol (tmp + rename)
        # pboxlint: disable-next=PB502 -- FS primitive, not a commit
        with self.open_write(path) as f:
            f.write(data)


class LocalFS(FileSystem):
    """≙ localfs_* (fs.cc).  Accepts bare paths and file:// URLs."""

    @staticmethod
    def _strip(path: str) -> str:
        return path[7:] if path.startswith("file://") else path

    def open_read(self, path: str):
        return open(self._strip(path), "rb")

    def open_write(self, path: str):
        path = self._strip(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # durable callers open a *.tmp name and commit via rename()
        # pboxlint: disable-next=PB502 -- the write primitive itself
        return open(path, "wb")

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def ls(self, path: str) -> List[str]:
        path = self._strip(path)
        return sorted(
            os.path.join(path, p) for p in os.listdir(path))

    def mkdir(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def remove(self, path: str) -> None:
        path = self._strip(path)
        if os.path.isdir(path):
            import shutil
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(self._strip(src), self._strip(dst))


class ShellFS(FileSystem):
    """Remote fs through shell commands, the reference's hdfs pattern
    (fs.cc hdfs_cat/hdfs_put/hdfs_ls/hdfs_mkdir/hdfs_remove built from a
    configurable command prefix: `hadoop fs [-D ugi] -verb`).

    Commands are templates with {path}; reads stream the cat's stdout,
    writes pipe into put's stdin.
    """

    def __init__(self, cat_cmd: str, put_cmd: str, ls_cmd: str = "",
                 mkdir_cmd: str = "", exists_cmd: str = "",
                 remove_cmd: str = "", rename_cmd: str = ""):
        self.cat_cmd = cat_cmd
        self.put_cmd = put_cmd
        self.ls_cmd = ls_cmd
        self.mkdir_cmd = mkdir_cmd
        self.exists_cmd = exists_cmd
        self.remove_cmd = remove_cmd
        self.rename_cmd = rename_cmd    # template with {src} and {dst}

    @classmethod
    def hadoop(cls, fs_name: str = "", ugi: str = "",
               binary: str = "hadoop") -> "ShellFS":
        """The stock hdfs/afs command set (≙ hdfs command assembly in
        fs.cc + the AFS ugi plumbing of box_wrapper.h:721)."""
        conf = ""
        if fs_name:
            conf += f" -D fs.default.name={shlex.quote(fs_name)}"
        if ugi:
            conf += f" -D hadoop.job.ugi={shlex.quote(ugi)}"
        base = f"{binary} fs{conf}"
        return cls(cat_cmd=base + " -cat {path}",
                   put_cmd=base + " -put - {path}",
                   ls_cmd=base + " -ls {path}",
                   mkdir_cmd=base + " -mkdir -p {path}",
                   exists_cmd=base + " -test -e {path}",
                   remove_cmd=base + " -rm -r {path}",
                   rename_cmd=base + " -mv {src} {dst}")

    def _run(self, tmpl: str, path: str, **kw):
        return subprocess.Popen(tmpl.format(path=shlex.quote(path)),
                                shell=True, **kw)

    def open_read(self, path: str):
        proc = self._run(self.cat_cmd, path, stdout=subprocess.PIPE)
        return _PipeReader(proc)

    def open_write(self, path: str):
        proc = self._run(self.put_cmd, path, stdin=subprocess.PIPE)
        return _PipeWriter(proc)

    def exists(self, path: str) -> bool:
        if not self.exists_cmd:
            raise NotImplementedError("no exists_cmd configured")
        proc = self._run(self.exists_cmd, path)
        return proc.wait() == 0

    def ls(self, path: str) -> List[str]:
        if not self.ls_cmd:
            raise NotImplementedError("no ls_cmd configured")
        proc = self._run(self.ls_cmd, path, stdout=subprocess.PIPE)
        out, _ = proc.communicate()
        # hadoop -ls prints permission/size columns; path is the last field
        names = []
        for line in out.decode(errors="replace").splitlines():
            parts = line.split()
            if parts and "/" in parts[-1]:
                names.append(parts[-1])
        return names

    def mkdir(self, path: str) -> None:
        if self.mkdir_cmd:
            rc = self._run(self.mkdir_cmd, path).wait()
            if rc != 0:
                raise IOError(f"fs mkdir failed rc={rc} for {path!r}")

    def remove(self, path: str) -> None:
        if self.remove_cmd:
            rc = self._run(self.remove_cmd, path).wait()
            if rc != 0:
                raise IOError(f"fs remove failed rc={rc} for {path!r}")

    def rename(self, src: str, dst: str) -> None:
        if not self.rename_cmd:
            raise NotImplementedError("no rename_cmd configured")
        cmd = self.rename_cmd.format(src=shlex.quote(src),
                                     dst=shlex.quote(dst))
        rc = subprocess.Popen(cmd, shell=True).wait()
        if rc != 0:
            raise IOError(f"fs rename failed rc={rc} for "
                          f"{src!r} -> {dst!r}")


class _PipeReader(io.RawIOBase):
    def __init__(self, proc):
        self._proc = proc

    def readable(self):
        return True

    def read(self, n=-1):
        return self._proc.stdout.read(n)

    def readinto(self, b):
        data = self._proc.stdout.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self):
        try:
            self._proc.stdout.close()
            rc = self._proc.wait()
            if rc != 0:
                raise IOError(f"fs read command failed rc={rc}")
        finally:
            super().close()


class _PipeWriter(io.RawIOBase):
    def __init__(self, proc):
        self._proc = proc

    def writable(self):
        return True

    def write(self, b):
        self._proc.stdin.write(b)
        return len(b)

    def close(self):
        try:
            self._proc.stdin.close()
            rc = self._proc.wait()
            if rc != 0:
                raise IOError(f"fs write command failed rc={rc}")
        finally:
            super().close()


# -- scheme registry (≙ fs_* dispatch-by-prefix, fs.cc) ---------------------

_REGISTRY: Dict[str, FileSystem] = {"": LocalFS(), "file": LocalFS()}


def register_fs(scheme: str, fs: FileSystem) -> None:
    """Register/replace the filesystem for a path scheme (e.g.
    register_fs("hdfs", ShellFS.hadoop(fs_name, ugi)) ≙ the AFS config
    handoff of box_wrapper.h:721-743)."""
    _REGISTRY[scheme.rstrip(":/")] = fs


def split_scheme(path: str):
    if "://" in path:
        scheme, rest = path.split("://", 1)
        return scheme, path
    return "", path


def get_fs(path: str) -> FileSystem:
    scheme, _ = split_scheme(path)
    fs = _REGISTRY.get(scheme)
    if fs is None:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(register_fs({scheme!r}, ShellFS.hadoop(...)))")
    return fs


def open_read(path: str):
    return get_fs(path).open_read(path)


def open_write(path: str):
    return get_fs(path).open_write(path)


def exists(path: str) -> bool:
    return get_fs(path).exists(path)
