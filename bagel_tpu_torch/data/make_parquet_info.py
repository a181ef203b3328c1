"""Generate parquet_info metadata for row-group-sharded datasets (port of
bagel_tpu/data/make_parquet_info.py).

The reference's interleaved datasets consume a precomputed
{path: {num_row_groups}} json (interleave_t2i_dataset.py:155-162, registered
via DATASET_INFO parquet_info_path). This tool builds it:

  python -m bagel_tpu_torch.data.make_parquet_info DIR [DIR ...] -o info.json
"""

from __future__ import annotations

import argparse
import json

from bagel_tpu_torch.data.datasets import list_parquet_files


def build_parquet_info(data_dirs) -> dict:
    import pyarrow.parquet as pq

    info = {}
    for path in list_parquet_files(data_dirs, [0] * len(data_dirs)):
        f = pq.ParquetFile(path)
        info[path] = {
            "num_row_groups": f.num_row_groups,
            "num_rows": f.metadata.num_rows,
        }
    return info


def main(argv=None):
    p = argparse.ArgumentParser("make_parquet_info")
    p.add_argument("dirs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)
    info = build_parquet_info(args.dirs)
    with open(args.output, "w") as f:
        json.dump(info, f, indent=2)
    print(f"{len(info)} parquet files -> {args.output}")


if __name__ == "__main__":
    main()
