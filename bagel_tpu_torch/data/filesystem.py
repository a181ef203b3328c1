"""Filesystem abstraction for parquet discovery and reads: local or HDFS
(port of bagel_tpu/data/filesystem.py).

Mirrors the reference's parquet_utils capability surface
(/root/reference/data/parquet_utils.py:15-95): `hdfs://` directories are
listed through the `hdfs dfs -ls` CLI and opened through pyarrow's
HadoopFileSystem; everything else is the local filesystem. Cluster
specifics (namenode host, block size, extra conf) are environment-variable
hooks instead of edit-this-function stubs:

    BAGEL_HDFS_HOST        e.g. hdfs://namenode  (default "default" = use
                           the cluster's fs.defaultFS from HADOOP_CONF_DIR)
    BAGEL_HDFS_BLOCK_SIZE  read buffer bytes (default 128 MiB)

Multi-host listing: each process lists its shard of the directory list and
the shards are exchanged with `torch.distributed.all_gather_object` when a
process group is initialized (one process: no exchange). pyarrow is
imported where a file is opened.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Sequence


def is_hdfs(path: str) -> bool:
    return path.startswith("hdfs://")


def hdfs_ls(directory: str) -> List[str]:
    """List a directory via the hdfs CLI (parquet_utils.py:93-95 semantics:
    take every line that carries an hdfs:// URI)."""
    result = subprocess.run(
        ["hdfs", "dfs", "-ls", directory], capture_output=True, text=True
    ).stdout
    return [
        "hdfs://" + line.split("hdfs://")[-1].strip()
        for line in result.split("\n")
        if "hdfs://" in line
    ]


def list_dir(directory: str) -> List[str]:
    """Full paths of directory entries, local or HDFS."""
    if is_hdfs(directory):
        return hdfs_ls(directory)
    return [os.path.join(directory, name) for name in os.listdir(directory)]


def split_hdfs_uri(path: str):
    """hdfs://[authority]/p/q -> (host, port, "/p/q").

    The authority in the URI wins; otherwise BAGEL_HDFS_HOST; otherwise
    "default" (the cluster's fs.defaultFS from HADOOP_CONF_DIR). The
    returned path is absolute — passing the authority along as a relative
    path would resolve against the HDFS home directory and open the wrong
    (usually nonexistent) file.
    """
    from urllib.parse import urlparse

    u = urlparse(path)
    host = u.hostname or os.environ.get("BAGEL_HDFS_HOST", "default")
    if host.startswith("hdfs://"):  # allow BAGEL_HDFS_HOST=hdfs://namenode
        host = urlparse(host).hostname or "default"
    return host, u.port or 0, u.path or "/"


def arrow_fs(path: str):
    """pyarrow filesystem for `path` (HadoopFileSystem for hdfs://)."""
    import pyarrow.fs as pf

    if is_hdfs(path):
        host, port, _ = split_hdfs_uri(path)
        return pf.HadoopFileSystem(
            host=host,
            port=port,
            buffer_size=int(
                os.environ.get("BAGEL_HDFS_BLOCK_SIZE", 134217728)
            ),
        )
    return pf.LocalFileSystem()


def open_parquet(path: str):
    """pyarrow.parquet.ParquetFile over the right filesystem."""
    import pyarrow.parquet as pq

    if is_hdfs(path):
        fs = arrow_fs(path)
        _, _, fpath = split_hdfs_uri(path)
        return pq.ParquetFile(fs.open_input_file(fpath))
    return pq.ParquetFile(path)


def get_parquet_data_paths(
    data_dir_list: Sequence[str],
    num_sampled_data_paths: Sequence[int],
    rank: int = 0,
    world_size: int = 1,
    allgather=None,
) -> List[str]:
    """Rank-sharded parquet discovery with repeat-to-count semantics
    (parquet_utils.py:15-56): each rank lists a chunk of the directories,
    repeats each directory's files to reach the requested count, and the
    per-rank lists are concatenated across ranks.

    allgather: optional callable list->list-of-lists; defaults to
    `allgather_object` when world_size > 1.
    """
    dirs = list(data_dir_list)
    counts = list(num_sampled_data_paths)
    if world_size > 1:
        chunk = -(-len(dirs) // world_size)
        lo = rank * chunk
        dirs, counts = dirs[lo : lo + chunk], counts[lo : lo + chunk]

    local: List[str] = []
    for d, n in zip(dirs, counts):
        files = sorted(p for p in list_dir(d) if p.endswith(".parquet"))
        if not files:
            continue
        if n and n > 0:
            files = (files * (n // len(files) + 1))[:n]
        local.extend(files)

    if world_size > 1:
        combined: List[str] = []
        for chunk_list in (allgather or allgather_object)(local):
            combined.extend(chunk_list)
        return combined
    return local


def allgather_object(obj) -> list:
    """All-gather a picklable object across the processes of the default
    torch.distributed group; [obj] when none is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
