"""Ensembles: replicate driver, EFA format, confidence and dispersion
(torch port of muscle_tpu.pipeline.ensemble).

Capability-equivalent of the reference ensemble layer (reference:
src/align.cpp:96-171 replicate loop, src/ensemble.{h,cpp},
src/maxcc.cpp, src/disperse.cpp, src/resample.cpp, src/addconfseq.cpp).

A column's identity is its vector of per-sequence residue positions
(reference: Ensemble::SetUniqueColMap, src/ensemble.cpp:428-480);
column confidence CC = fraction of replicates containing that exact
column. Replicates are generated by HMM perturbation seeds x guide-tree
permutations. Plain-MPC ensembles run all replicates' pair grids as one
device stream (pipeline/ensemble_batch.py); `.mega`, Super5/6/7 and
explicit-tree inputs run the serial loop, one pipeline run a replicate.
The device stages run on the card unless the CPU is asked for (opts
"device"); the EFA tools are host code.
"""

from __future__ import annotations

import numpy as np

from ..qscore import qscore
from ..sequence import MultiSequence, Sequence
from ..utils.rng import MwcRng

TREE_PERM_NAMES = ("none", "abc", "acb", "bca")


# ---------------------------------------------------------------------------
# replicate loop (-align / -super5/6/7 with ensembles)
# ---------------------------------------------------------------------------

def make_replicate_file_name(pattern: str, perm: str, seed: int) -> str:
    """'@' in the output pattern expands to '<perm>.<seed>'
    (reference: src/align.cpp:4-20)."""
    if "@" not in pattern:
        raise ValueError("'@' not found in output pattern")
    pos = pattern.index("@")
    return f"{pattern[:pos]}{perm}.{seed}{pattern[pos + 1:]}"


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


def run_align_command(cmd: str, input_path: str, output_pattern: str,
                      opts: dict) -> None:
    """Implements -align / -super5 / -super6 / -super7 including the
    ensemble replicate loop (reference: cmd_align src/align.cpp:55-171).
    opts are the CLI's options by name; opts["device"] ("cuda" or "cpu",
    default the card) is where the device stages run."""
    from ..alphabet import ALPHA_AMINO, ALPHA_NUCLEO, guess_is_nucleo
    from ..hmm.params import HMMParams
    from ..utils.device import resolve_device
    from .mpc import MPC, DEFAULT_CONSISTENCY_ITERS, DEFAULT_REFINE_ITERS

    if cmd not in ("align", "super5", "super6", "super7"):
        raise ValueError(f"unknown align command {cmd!r}")
    device = resolve_device(opts.get("device"))
    seqs, mega = load_input(input_path, force_mega=bool(opts.get("mega")))
    n = len(seqs)

    minsuper = int(opts.get("minsuper", 0) or 0)
    use_super5 = cmd == "super5" or bool(minsuper and n >= minsuper)
    use_super6 = cmd == "super6"
    use_super7 = cmd == "super7"

    # structure profiles are protein chains, whatever -nt says
    if mega is not None:
        nucleo = False
    elif opts.get("nt"):
        nucleo = True
    elif opts.get("amino"):
        nucleo = False
    else:
        nucleo = guess_is_nucleo(seqs, MwcRng(1))
    alpha = ALPHA_NUCLEO if nucleo else ALPHA_AMINO

    stratified = bool(opts.get("stratified"))
    diversified = bool(opts.get("diversified"))
    if stratified and diversified:
        raise SystemExit("cannot set both -stratified and -diversified")

    rep_count = 1
    if stratified:
        rep_count = 16
    elif diversified:
        rep_count = 100
    if "replicates" in opts:
        rep_count = int(opts["replicates"])
        if stratified:
            rep_count *= 4

    consiters = int(opts.get("consiters", DEFAULT_CONSISTENCY_ITERS))
    refineiters = int(opts.get("refineiters", DEFAULT_REFINE_ITERS))

    def load_hp():
        if opts.get("hmmin"):
            return HMMParams.from_file(str(opts["hmmin"]))
        return HMMParams.from_defaults(nucleo=nucleo)

    guide_tree_in = None
    if opts.get("guidetreein"):
        from ..tree.tree import Tree
        guide_tree_in = Tree.from_file(str(opts["guidetreein"]))

    def one(perturb_seed: int, perm: str) -> MultiSequence:
        hp = load_hp()
        if perturb_seed > 0:
            hp.perturb(perturb_seed)
        if opts.get("hmmout"):
            hp.to_file(str(opts["hmmout"]))
        if use_super7:
            from .super7 import DEFAULT_SHRUB_SIZE, Super7
            dist_mx = None
            if opts.get("distmxin"):
                from ..tree.upgma import read_distmx_reseek
                labels_d, dist_mx = read_distmx_reseek(str(opts["distmxin"]))
                # permute into input sequence order
                pos = {lb: i for i, lb in enumerate(labels_d)}
                perm_idx = np.array([pos[s.label] for s in seqs])
                dist_mx = dist_mx[np.ix_(perm_idx, perm_idx)]
            s7 = Super7(shrub_size=int(opts.get("shrub_size",
                                                DEFAULT_SHRUB_SIZE)),
                        consistency_iters=consiters,
                        refine_iters=refineiters, mega=mega, device=device)
            return s7.run(seqs, hp, alpha, guide_tree=guide_tree_in,
                          dist_mx=dist_mx)
        if use_super6:
            from .super6 import Super6
            from .uclustpd import DEFAULT_MAX_PD_PASS1, DEFAULT_SEEDS_PER_ITER
            s6 = Super6(consistency_iters=consiters,
                        refine_iters=refineiters,
                        max_pd1=float(opts.get("super6_maxpd1",
                                               DEFAULT_MAX_PD_PASS1)),
                        seeds_per_iter=int(
                            opts.get("threads", DEFAULT_SEEDS_PER_ITER)),
                        device=device)
            return s6.run(seqs, hp, alpha)
        if use_super5:
            from .super5 import Super5
            s5 = Super5(consistency_iters=consiters,
                        refine_iters=refineiters, tree_perm=perm,
                        device=device)
            return s5.run(seqs, hp, alpha)
        mpc = MPC(consistency_iters=consiters, refine_iters=refineiters,
                  tree_perm=perm, device=device,
                  guide_tree_in=guide_tree_in,
                  input_order=bool(opts.get("input_order")), mega=mega)
        msa = mpc.run(seqs, hp, alpha)
        if opts.get("guidetreeout"):
            # save the tree this run used and return the MSA as it came,
            # not put into input order (src/mpcflat.cpp:196-204)
            mpc.guide_tree.to_file(str(opts["guidetreeout"]))
            return msa
        if opts.get("input_order"):
            by_label = {s.label: s for s in msa}
            msa = MultiSequence([by_label[s.label] for s in seqs])
        return msa

    wildcard = "@" in output_pattern
    if rep_count == 1:
        seed = int(opts.get("perturb", 0) or 0)
        perm = str(opts.get("perm", "none") or "none")
        out = (make_replicate_file_name(output_pattern, perm, seed)
               if wildcard else output_pattern)
        one(seed, perm).write_fasta(out)
        return

    def rep_schedule():
        for rep in range(rep_count):
            seed = rep // 4 if stratified else rep
            perm = (str(opts["perm"]) if opts.get("perm")
                    else TREE_PERM_NAMES[rep % 4])
            yield seed, perm

    def emit(f, seed, perm, msa):
        if wildcard:
            msa.write_fasta(make_replicate_file_name(output_pattern,
                                                     perm, seed))
        else:
            f.write(f"<{perm}.{seed}\n")
            msa.write_fasta(f)

    # plain-MPC ensembles batch all replicates' pair grids into one
    # device stream (pipeline/ensemble_batch.py); pipelines with extra
    # host state (super5/6/7, mega, explicit trees) keep the serial loop,
    # and so do pads beyond the batched stream's LONG_PAIR_THRESHOLD
    from .posteriors import LONG_PAIR_THRESHOLD, round_up
    batched_ok = (cmd == "align"
                  and not (use_super5 or use_super6 or use_super7)
                  and mega is None and guide_tree_in is None
                  and not opts.get("guidetreeout")
                  and not opts.get("input_order")
                  and round_up(max(len(s) for s in seqs), 128)
                  <= LONG_PAIR_THRESHOLD)
    f = None if wildcard else open(output_pattern, "w")
    try:
        if batched_ok:
            from .ensemble_batch import run_replicates_batched
            for seed, perm, msa in run_replicates_batched(
                    seqs, list(rep_schedule()), load_hp, alpha,
                    consiters, refineiters, device,
                    hmmout=(str(opts["hmmout"]) if opts.get("hmmout")
                            else None)):
                emit(f, seed, perm, msa)
        else:
            for seed, perm in rep_schedule():
                emit(f, seed, perm, one(seed, perm))
    finally:
        if f:
            f.close()


# ---------------------------------------------------------------------------
# Ensemble analytics
# ---------------------------------------------------------------------------

class Ensemble:
    def __init__(self, names: list[str], msas: list[MultiSequence]):
        self.names = names
        self.msas = msas
        self._derive()

    # -- I/O -------------------------------------------------------------
    @classmethod
    def from_efa(cls, path: str) -> "Ensemble":
        with open(path) as f:
            text = f.read()
        if not text.startswith("<"):
            # file of MSA paths (reference: Ensemble::FromMSAPaths)
            names = [ln.strip() for ln in text.splitlines() if ln.strip()]
            return cls(names, [MultiSequence.from_fasta(p) for p in names])
        names = []
        blocks = []
        cur: list[str] | None = None
        for line in text.splitlines():
            if line.startswith("<"):
                names.append(line[1:].strip())
                cur = []
                blocks.append(cur)
            elif cur is not None:
                cur.append(line)
        msas = [MultiSequence.from_fasta_text("\n".join(b)) for b in blocks]
        return cls(names, msas)

    # -- derived column maps (reference: Ensemble::SetDerived) -----------
    def _derive(self) -> None:
        if not self.msas:
            return
        m0 = self.msas[0]
        label_order = {s.label: i for i, s in enumerate(m0)}
        # sort all MSAs into MSA0's row order, upper-case
        for k in range(len(self.msas)):
            rows = {s.label: s for s in self.msas[k]}
            if set(rows) != set(label_order):
                raise ValueError("ensemble members have different labels")
            self.msas[k] = MultiSequence(
                [Sequence(lb, rows[lb].text().upper())
                 for lb in label_order])

        # column identity = tuple of per-seq residue positions (1-based,
        # 0 for gap); confidence = replicate fraction with that column
        self._col_keys: list[list[tuple]] = []
        counts: dict[tuple, int] = {}
        for msa in self.msas:
            mat = msa.to_matrix()
            nongap = (mat != ord("-")) & (mat != ord("."))
            pos = np.cumsum(nongap, axis=1) * nongap   # 1-based, 0 for gap
            keys = [tuple(pos[:, c]) for c in range(mat.shape[1])]
            self._col_keys.append(keys)
            for k in keys:
                counts[k] = counts.get(k, 0) + 1
        self._col_counts = counts

    @property
    def msa_count(self) -> int:
        return len(self.msas)

    def col_conf(self, msa_index: int, col: int) -> float:
        key = self._col_keys[msa_index][col]
        return self._col_counts[key] / self.msa_count

    def total_conf(self, msa_index: int) -> float:
        return sum(self._col_counts[k] for k in self._col_keys[msa_index]
                   ) / self.msa_count

    def median_conf(self, msa_index: int) -> float:
        """Median per-column confidence (reference: Ensemble::GetMedianConf)."""
        confs = sorted(self.col_conf(msa_index, c)
                       for c in range(self.msas[msa_index].col_count()))
        return confs[len(confs) // 2] if confs else 0.0

    def n1(self, msa_index: int) -> int:
        """Count of columns present in every replicate (conf == 1,
        reference: Ensemble::GetN1)."""
        return sum(1 for c in range(self.msas[msa_index].col_count())
                   if self._col_counts[self._col_keys[msa_index][c]]
                   == self.msa_count)

    def best_conf_stats(self) -> list[dict]:
        """Per-replicate stats for -efa_bestconf
        (reference: src/efabestconf.cpp:26-49)."""
        out = []
        for i in range(self.msa_count):
            cols = self.msas[i].col_count()
            n1 = self.n1(i)
            out.append({
                "index": i, "name": self.names[i], "cols": cols,
                "n1": n1, "n1f": n1 / cols if cols else 0.0,
                "total_conf": self.total_conf(i),
                "median_conf": self.median_conf(i)})
        return out

    def best_cols_msa(self, min_conf: float = 1.0,
                      max_gap_fract: float = 0.5,
                      max_cols: int | None = None) -> MultiSequence:
        """MSA of the highest-confidence unique columns
        (reference: cmd_efa_bestcols src/efabestcols.cpp:5-64 — filter by
        conf >= min_conf and gap fraction <= max_gap_fract, order by
        descending confidence, keep <= max_cols)."""
        order, seen = self._unique_cols()
        nseq = len(self.msas[0])
        picked = []
        for k in order:
            conf = self._col_counts[k] / self.msa_count
            if conf < min_conf:
                continue
            if sum(1 for p in k if p == 0) / nseq > max_gap_fract:
                continue
            picked.append((conf, seen[k]))
        picked.sort(key=lambda t: -t[0])   # stable: ties keep seen order
        if max_cols is not None:
            picked = picked[:max_cols]
        labels = self.msas[0].labels()
        if not picked:
            return MultiSequence([Sequence(lb, "") for lb in labels])
        mat = np.stack([self._col_letters(mi, c) for _, (mi, c) in picked],
                       axis=1)
        return MultiSequence([Sequence(lb, mat[i])
                              for i, lb in enumerate(labels)])

    def _ref_keys(self, ref: MultiSequence, max_gap_fract: float
                  ) -> tuple[set, set]:
        """Reference-column keys in ensemble canonical space + the set of
        (seq, position) pairs those columns cover (reference:
        Ensemble::GetRefUniqueIxs/GetRefPosSet)."""
        label_order = [s.label for s in self.msas[0]]
        rows = {s.label: s for s in ref}
        mat = np.stack([rows[lb].bytes_view() for lb in label_order])
        # uppercase letters only; '.' and lowercase denote non-core
        nongap = (mat != ord("-")) & (mat != ord("."))
        pos = np.cumsum(nongap, axis=1) * nongap
        gapfract = 1.0 - nongap.mean(axis=0)
        keys = set()
        pos_set = set()
        for c in range(mat.shape[1]):
            if gapfract[c] > max_gap_fract:
                continue
            keys.add(tuple(pos[:, c]))
            for i in range(mat.shape[0]):
                if nongap[i, c]:
                    pos_set.add((i, int(pos[i, c])))
        return keys, pos_set

    def colscore(self, ref: MultiSequence, max_gap_fract: float = 0.5
                 ) -> dict:
        """Mean TC vs a reference alignment + confidence-bin calibration
        (reference: cmd_colscore_efa src/colscoreefa.cpp:18-102; bins of
        width 0.1, bin 10 = conf exactly 1)."""
        ref_keys, ref_pos = self._ref_keys(ref, max_gap_fract)
        nbins = 11
        bin_count = [0] * nbins
        bin_correct = [0] * nbins
        sum_tc = 0.0
        for mi in range(self.msa_count):
            correct = 0
            for c, key in enumerate(self._col_keys[mi]):
                # test col restricted to columns within ref positions
                if not all((i, p) in ref_pos
                           for i, p in enumerate(key) if p != 0):
                    continue
                conf = self._col_counts[key] / self.msa_count
                b = 10 if conf == 1.0 else int(conf * 10)
                bin_count[b] += 1
                if key in ref_keys:
                    correct += 1
                    bin_correct[b] += 1
            sum_tc += correct / max(len(ref_keys), 1)
        bins = [{"bin": b, "count": bin_count[b],
                 "correct": bin_correct[b],
                 "p": bin_correct[b] / bin_count[b] if bin_count[b] else 0.0}
                for b in range(nbins)]
        return {"mean_tc": sum_tc / self.msa_count, "bins": bins}

    def max_cc(self) -> int:
        """Replicate index with max total confidence (ties: last wins,
        reference: src/maxcc.cpp TotalConf >= BestConf)."""
        best, best_conf = 0, -1.0
        for i in range(self.msa_count):
            c = self.total_conf(i)
            if c >= best_conf:
                best, best_conf = i, c
        return best

    # -- dispersion (reference: Ensemble::GetDispersion) -----------------
    def dispersion(self, max_gap_fract: float = 0.5) -> tuple[float, float]:
        qs, tcs = [], []
        n = self.msa_count
        for i in range(n):
            for j in range(i + 1, n):
                qij, tcij = self._pair_qtc(i, j, max_gap_fract)
                qji, tcji = self._pair_qtc(j, i, max_gap_fract)
                qs.append((qij + qji) / 2)
                tcs.append((tcij + tcji) / 2)
        qs.sort()
        tcs.sort()
        return 1.0 - qs[len(qs) // 2], 1.0 - tcs[len(tcs) // 2]

    def _pair_qtc(self, ref_i: int, test_i: int,
                  max_gap_fract: float) -> tuple[float, float]:
        ref = self._gap_filtered(ref_i, max_gap_fract)
        return qscore(self.msas[test_i], ref)

    def _gap_filtered(self, i: int, max_gap_fract: float) -> MultiSequence:
        """Lower-case the columns of MSA i whose gap fraction exceeds the
        threshold so qscore ignores them (QScorer::m_MaxGapFract)."""
        msa = self.msas[i]
        mat = msa.to_matrix()
        gaps = ((mat == ord("-")) | (mat == ord("."))).mean(axis=0)
        bad = gaps > max_gap_fract
        if not bad.any():
            return msa
        out = []
        for s in msa:
            chars = np.array(list(s.text()))
            chars[bad] = np.char.lower(chars[bad])
            out.append(Sequence(s.label, "".join(chars)))
        return MultiSequence(out)

    # -- resampling (reference: src/resample.cpp) ------------------------
    def _unique_cols(self) -> tuple[list[tuple], dict[tuple, tuple[int, int]]]:
        """Unique column keys in first-seen order + a representative
        (msa_index, col) for each."""
        seen: dict[tuple, tuple[int, int]] = {}
        order: list[tuple] = []
        for mi, keys in enumerate(self._col_keys):
            for c, k in enumerate(keys):
                if k not in seen:
                    seen[k] = (mi, c)
                    order.append(k)
        return order, seen

    def _col_letters(self, mi: int, c: int) -> np.ndarray:
        return self.msas[mi].to_matrix()[:, c]

    def hi_qual_unique_cols(self, max_gap_fract: float = 0.5,
                            min_conf: float = 0.5) -> list[tuple[int, int]]:
        order, seen = self._unique_cols()
        out = []
        nseq = len(self.msas[0])
        for k in order:
            conf = self._col_counts[k] / self.msa_count
            if conf < min_conf:
                continue
            gapfract = sum(1 for p in k if p == 0) / nseq
            if gapfract <= max_gap_fract:
                out.append(seen[k])
        return out

    def median_hi_qual_col_count(self, max_gap_fract: float = 0.5,
                                 min_conf: float = 0.5) -> int:
        counts = []
        for mi in range(self.msa_count):
            mat = self.msas[mi].to_matrix()
            n = 0
            for c in range(mat.shape[1]):
                if self.col_conf(mi, c) < min_conf:
                    continue
                col = mat[:, c]
                gapfract = np.mean((col == ord("-")) | (col == ord(".")))
                if gapfract <= max_gap_fract:
                    n += 1
            counts.append(n)
        counts.sort()
        return counts[len(counts) // 2]

    def resample_to_file(self, path: str, replicates: int = 100,
                         seed: int = 1, max_gap_fract: float = 0.5,
                         min_conf: float = 0.5) -> None:
        site_count = self.median_hi_qual_col_count(max_gap_fract, min_conf)
        if site_count == 0:
            raise ValueError("all columns low quality")
        pool = self.hi_qual_unique_cols(max_gap_fract, min_conf)
        rng = MwcRng(seed)
        labels = self.msas[0].labels()
        with open(path, "w") as f:
            for rep in range(replicates):
                cols = [pool[rng.randu32() % len(pool)]
                        for _ in range(site_count)]
                mat = np.stack([self._col_letters(mi, c) for mi, c in cols],
                               axis=1)
                f.write(f"<resampled.{rep + 1}\n")
                MultiSequence([Sequence(lb, mat[i])
                               for i, lb in enumerate(labels)]).write_fasta(f)

    # -- confidence outputs (reference: src/addconfseq.cpp, letterconf) --
    def conf_seq(self, msa_index: int, decimals: int = 1) -> str:
        out = []
        ncols = self.msas[msa_index].col_count()
        for c in range(ncols):
            conf = self.col_conf(msa_index, c)
            if decimals == 1:
                t = int(conf * 10)
                out.append("+" if t == 10 else chr(ord("0") + t))
            else:
                h = int(conf * 100)
                out.append("+" if h == 100 else chr(ord("0") + h % 10))
        return "".join(out)

    def write_with_conf_seq(self, path: str, label: str = "_conf_") -> None:
        with open(path, "w") as f:
            for name, msa in zip(self.names, self.msas):
                f.write(f"<{name}\n")
                i = self.names.index(name)
                f.write(f">{label}\n{self.conf_seq(i, 1)}\n")
                f.write(f">{label}2\n{self.conf_seq(i, 2)}\n")
                msa.write_fasta(f)

    # conf -> 1-char symbol (reference: ConfToChar_1 src/addconfseq.cpp:25-33)
    _CONF_SYMBOLS = "___.,/:=@*^"

    def letter_confs(self, ref: MultiSequence) -> np.ndarray:
        """(ref seqs, ref cols) per-letter confidence: the fraction of
        replicates in which the letter sits in its reference column's
        strict-majority test column (reference:
        Ensemble::GetLetterConfsVec src/letterconf.cpp:11-45)."""
        from ..qscore import ref_letter_counts
        counts = None
        for msa in self.msas:
            c = ref_letter_counts(msa, ref)
            counts = c if counts is None else counts + c
        return counts / self.msa_count

    def conf_aln(self, ref: MultiSequence) -> MultiSequence:
        """Copy of the reference alignment with every letter replaced by
        its confidence symbol (reference: cmd_letterconf
        src/letterconf.cpp:72-89)."""
        confs = self.letter_confs(ref)
        out = []
        for ri, s in enumerate(ref):
            chars = list(s.text())
            for c, ch in enumerate(chars):
                if ch not in "-.":
                    chars[c] = self._CONF_SYMBOLS[int(confs[ri, c] * 10)]
            out.append(Sequence(s.label, "".join(chars)))
        return MultiSequence(out)

    def letter_conf_html(self, out_path: str, ref: MultiSequence) -> None:
        """Reference alignment colored by per-letter confidence
        (reference: WriteLetterConfHTML src/letterconfhtml.cpp)."""
        confs = self.letter_confs(ref)
        # 5-step heat map, red (low) -> green (high)
        palette = ["#d73027", "#fc8d59", "#fee08b", "#d9ef8b", "#1a9850"]
        with open(out_path, "w") as f:
            f.write("<html><body style='font-family:monospace'>\n")
            for ri, s in enumerate(ref):
                f.write(f"<div>&gt;{s.label}</div><div>")
                for c, ch in enumerate(s.text()):
                    if ch in "-.":
                        f.write(ch)
                    else:
                        color = palette[min(int(confs[ri, c] * 5), 4)]
                        f.write(f"<span style='background:{color}'>"
                                f"{ch}</span>")
                f.write("</div>\n")
            f.write("</body></html>\n")

    def letter_conf_jalview(self, out_path: str, ref: MultiSequence) -> None:
        """Jalview annotation with per-column mean letter confidence
        (reference: WriteLetterConfJalView src/jalview.cpp)."""
        confs = self.letter_confs(ref)
        mat = ref.to_matrix()
        letters = (mat != ord("-")) & (mat != ord("."))
        n = letters.sum(axis=0)
        mean = np.where(n > 0, (confs * letters).sum(axis=0)
                        / np.maximum(n, 1), 0.0)
        with open(out_path, "w") as f:
            f.write("JALVIEW_ANNOTATION\n")
            vals = "|".join(f"{v:.2f}" for v in mean)
            f.write(f"BAR_GRAPH\tLetter confidence\t{vals}\n")

    def letter_conf(self, ref: MultiSequence, out_path: str | None
                    ) -> dict[str, float]:
        """-letterconf driver: write the confidence-symbol alignment and
        summarize (reference: cmd_letterconf src/letterconf.cpp:47-92)."""
        confs = self.letter_confs(ref)
        if out_path:
            self.conf_aln(ref).write_fasta(out_path)
        mat = ref.to_matrix()
        letters = (mat != ord("-")) & (mat != ord("."))
        q, tc = qscore(self.msas[0], ref)
        return {"Q": q, "TC": tc,
                "mean_conf": float(confs[letters].mean())}
