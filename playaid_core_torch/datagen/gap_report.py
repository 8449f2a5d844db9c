"""Report requested replays that have not been processed yet.

The port's copy of ``playaid_core_tpu/datagen/gap_report.py`` (reference:
data_gen_scripts/output_incomplete_games.py:1-22): it diffs a replay-id ->
requester-email map against a store of completed replays and prints the
ids still owed, one per line in the reference's copy-paste-into-config
format (``    "<id>", // <email>``).

* **requests**: a JSON object ``{replay_id: email}`` or a CSV of
  ``replay_id,email`` rows (``#`` comments skipped, like the pairings
  CSV — reference: timeline.py:166-183).
* **completed store**: a directory of pipeline outputs, where a replay
  counts as completed when ``<id>.mp4`` / ``<id>.yaml`` / ``<id>.yml`` or
  a ``<id>`` subdirectory exists, or any iterable of completed ids (or
  records with a ``replay_id`` attribute, the shape the reference's
  ``get_replays()`` rows had).

The command line parses with argparse.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterable, List, Tuple


def load_requests(path: str) -> Dict[str, str]:
    """Load the replay_id -> email request map from JSON or CSV."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        data = json.loads(text)
        return {str(k): str(v) for k, v in data.items()}
    requests: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 2:
            raise ValueError(f"bad request row (want 'replay_id,email'): {line!r}")
        requests[parts[0]] = parts[1]
    return requests


def completed_replay_ids(store) -> set:
    """Normalize a completed-replay store to a set of replay ids.

    ``store`` is a directory path (scanned for the artifacts above), or
    any iterable of ids / records carrying ``replay_id``.
    """
    if isinstance(store, str):
        if not os.path.isdir(store):
            return set()
        done = set()
        for name in os.listdir(store):
            base, ext = os.path.splitext(name)
            if os.path.isdir(os.path.join(store, name)):
                done.add(name)
            elif ext.lower() in (".mp4", ".yaml", ".yml"):
                done.add(base)
        return done
    return {str(getattr(r, "replay_id", r)) for r in store}


def incomplete_games(requests: Dict[str, str], completed) -> List[Tuple[str, str]]:
    """(replay_id, email) pairs requested but absent from the store, sorted
    by replay id so the report is deterministic (the reference printed set
    order; output_incomplete_games.py:8-14)."""
    done = completed_replay_ids(completed)
    return sorted((rid, email) for rid, email in requests.items() if rid not in done)


def format_report(pairs: Iterable[Tuple[str, str]]) -> str:
    """The reference's copy-paste format (output_incomplete_games.py:15-21)."""
    return "\n".join(f'    "{rid}", // {email}' for rid, email in pairs)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.datagen.gap_report",
        description="Print replay ids requested but not yet processed.")
    p.add_argument("--requests", dest="requests_path", required=True,
                   help="JSON {replay_id: email} or CSV 'replay_id,email' rows")
    p.add_argument("--store", dest="store_dir", required=True,
                   help="directory of completed pipeline outputs to scan")
    args = p.parse_args(argv)
    pairs = incomplete_games(load_requests(args.requests_path), args.store_dir)
    out = format_report(pairs)
    if out:
        print(out)
    print(f"# {len(pairs)} incomplete", flush=True)


if __name__ == "__main__":
    main()
