"""What the caption cells share: the program's Captioner built from the
seed, and the check of returned captions against the plain reference."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench import inputs
from portbench.harness import Check, Run
from portbench.reference import model as ref


def vocab_size(run: Run) -> int:
    return run.config["vocab_size"]


def weights_seed(run: Run) -> int:
    """The seed of the served model's weights: the traffic's `weights_seed`
    where it names one (a service deploys one model, so every run's seed
    draws only the clips and their order, and each seed asks the same work
    of it), else the run's."""
    return int(run.traffic.get("weights_seed", run.seed))


def make_captioner(run: Run, device):
    """The program's Captioner over the seed's weights (the serving path of
    `cli serve` without a bundle: `Captioner.from_params`)."""
    from dlsg_tpu_torch.serve import Captioner
    from dlsg_tpu_torch.vocab import Vocabulary

    V = vocab_size(run)
    shapes, _ = ref.param_shapes(run.model_dict("serving"), V)
    params = inputs.make_params(shapes, weights_seed(run), "generator", device, run.config["length_model"])
    vocab = Vocabulary.from_idx2word(inputs.vocab_words(V))
    cap = Captioner.from_params(run.program_config("serving"), vocab, params, device=device)
    del params
    return cap


def word_counts(captions: Sequence[str]) -> List[int]:
    return [len(c.split()) for c in captions]


def ids_to_text(ids, vocab: int) -> List[str]:
    """Token ids [n, T] as the captions the program returns them."""
    words = inputs.vocab_words(vocab)
    out = []
    for row in np.asarray(ids).tolist():
        row = row[: row.index(inputs.END_ID)] if inputs.END_ID in row else row
        out.append(" ".join(words[t] for t in row))
    return out


def token_mismatch(served: Sequence[str], ref_ids, max_words: int) -> Tuple[float, int]:
    """% of token positions where a served caption differs from the
    reference's best beam, each caption read up to the later of the two
    `<end>`s (a caption without one runs `max_words` tokens), and the
    number of positions read."""
    diff = total = 0
    for text, r in zip(served, ref_ids):
        a = inputs.caption_ids(text) + [inputs.END_ID]
        r = [int(t) for t in r]
        b = r[: r.index(inputs.END_ID) + 1] if inputs.END_ID in r else r
        n = min(max(len(a), len(b)), max_words)
        a += [inputs.END_ID] * (n - len(a))
        b += [inputs.END_ID] * (n - len(b))
        diff += sum(x != y for x, y in zip(a[:n], b[:n]))
        total += n
    return 100.0 * diff / max(total, 1), total


def reference_captions(run: Run, frames, regions, device, mode: str = "fp32",
                       block: int = 64) -> np.ndarray:
    """The reference's best beam-5 ids [n, max_words] of host clips, in
    blocks of `block` rows."""
    import torch

    md = run.model_dict("serving")
    V = vocab_size(run)
    shapes, _ = ref.param_shapes(md, V)
    p = inputs.make_params(shapes, weights_seed(run), "generator", device, run.config["length_model"])
    out = []
    with ref.precision(mode):
        for s in range(0, len(frames), block):
            fr = torch.as_tensor(np.ascontiguousarray(frames[s: s + block]), device=device)
            rg = torch.as_tensor(np.ascontiguousarray(regions[s: s + block]), device=device)
            out.append(ref.beam_decode(p, md, fr, rg, md["beam_size"]).cpu().numpy())
    del p
    return np.concatenate(out, 0)


def check_captions(run: Run, served: Sequence[str], frames, regions, device,
                   mode: str = "fp32") -> Tuple[Check, Dict[str, float]]:
    """The served captions against the reference's decode of the same clips."""
    ids = reference_captions(run, frames, regions, device, mode)
    pct, n = token_mismatch(served, ids, run.config["model"]["max_words"])
    limit = run.config["limits"]["token_mismatch_pct"]
    return Check("token_mismatch_pct", pct, limit), {"tokens_compared": n}


def sample_with_longest(rng: np.random.Generator, lengths: Sequence[int], n: int) -> np.ndarray:
    """`n` indices drawn without replacement, the longest caption's among
    them."""
    lengths = np.asarray(lengths)
    longest = int(np.argmax(lengths))
    rest = np.delete(np.arange(len(lengths)), longest)
    pick = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return np.sort(np.append(pick, longest))
