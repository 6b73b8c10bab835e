"""Input loading of the align commands (torch port of the part of
muscle_tpu.pipeline.ensemble that one replicate needs; the replicate
loop, EFA and confidence tools are ROADMAP.md queue 1, item 11)."""

from __future__ import annotations

from ..sequence import MultiSequence, Sequence


def load_input(input_path: str, force_mega: bool = False):
    """FASTA or .mega input (reference: LoadInput src/loadinput.cpp:3-13
    dispatches on the mega header or the -mega flag).
    Returns (seqs, mega_or_None)."""
    with open(input_path) as f:
        first = f.read(5)
    if force_mega or first.startswith("mega"):
        from ..io.mega import parse_mega
        mega = parse_mega(input_path)
        seqs = MultiSequence([Sequence(lb, sq)
                              for lb, sq in zip(mega.labels, mega.seqs)])
        return seqs, mega
    return MultiSequence.from_fasta(input_path), None
