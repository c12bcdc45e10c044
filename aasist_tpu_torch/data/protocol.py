"""ASVspoof CM protocol parsing (own copy of
``aasist_tpu/data/protocol.py``).

Protocol line format: ``speaker utt_id - attack_id key`` where key is
``bonafide`` or ``spoof``, e.g.::

    LA_0079 LA_T_1138215 - - bonafide
    LA_0079 LA_T_1271820 - A01 spoof

Entries keep the (src, key) columns the score file needs.  Label
convention (the reference's ``genSpoof_list``): bonafide=1, spoof=0.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple, Union


@dataclasses.dataclass(frozen=True)
class ProtocolEntry:
    speaker: str
    utt_id: str
    src: str       # attack id column ("-" for bonafide)
    key: str       # "bonafide" | "spoof"

    @property
    def label(self) -> int:
        return 1 if self.key == "bonafide" else 0


def parse_protocol(path: Union[str, Path]) -> List[ProtocolEntry]:
    entries: List[ProtocolEntry] = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if not parts or parts == [""]:
                continue
            speaker, utt_id, _, src, key = parts
            entries.append(ProtocolEntry(speaker, utt_id, src, key))
    return entries


def trial_metadata(entries: List[ProtocolEntry]
                   ) -> Dict[str, Tuple[str, str]]:
    """utt_id -> (src, key), the score-file columns."""
    return {e.utt_id: (e.src, e.key) for e in entries}


def labels_and_files(entries: List[ProtocolEntry]
                     ) -> Tuple[Dict[str, int], List[str]]:
    """genSpoof_list-compatible view: (label dict, file list)."""
    return {e.utt_id: e.label for e in entries}, [e.utt_id for e in entries]
