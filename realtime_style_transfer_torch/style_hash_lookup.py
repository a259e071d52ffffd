"""Reverse-lookup a wikiart image file's hash to its manifest row.

Twin of the repository's ``style_hash_lookup.py``, with the same argument.
It reads a CSV and does no device work, so unlike the port's other CLIs it
has no ``--device`` and runs where there is no GPU.

    python -m realtime_style_transfer_torch.style_hash_lookup \\
        a6ab05c7e9f6e8810d3567c699f620b07600ae19
"""

from __future__ import annotations

import argparse
import json

from .tracing import logsetup


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("image_hash", type=str,
                   help="sha1 filename stem of a wikiart image")
    args = p.parse_args(argv)
    logsetup.setup()

    from .data.wikiart import lookup_manifest_by_hash

    row = lookup_manifest_by_hash(args.image_hash)
    if row is None:
        print(f"no manifest row found for {args.image_hash}")
        raise SystemExit(1)
    print(json.dumps(row, indent=2))
    return row


if __name__ == "__main__":
    main()
