"""Federated PersonaChat: client = distinct personality.

numpy/``random``-only copy of ``commefficient_tpu/data/fed_persona.py``
(the port imports nothing of the JAX package): the same on-disk layout
(per-client ``client{i}.json`` + ``validation.json`` + ``stats.json``
split from the personachat archive) and the same items:

- an item is one utterance: ``num_candidates`` candidate sequences
  (gold last), built as
  ``[bos persona] [<speaker1/2> turn]... [<speaker2> reply eos]``
  with speaker-alternating token types, LM labels only on the gold
  reply, mc_token_id at the last position, mc_label = gold index;
- history truncated to ``2*max_history + 1`` turns;
- ``personality_permutations`` random persona shufflings per item.

No download: place ``personachat_self_original.json`` in the dataset
dir, or write one with ``generate_learnable_personachat`` /
``generate_synthetic_personachat`` (same seed, byte-identical files).
The collate pads to a static ``max_seq_len``.
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.tokenizer import SPECIAL_TOKENS

__all__ = ["FedPERSONA", "persona_collate",
           "generate_synthetic_personachat",
           "generate_learnable_personachat"]

MODEL_INPUTS = ["input_ids", "mc_token_ids", "lm_labels", "mc_labels",
                "token_type_ids"]

RAW_NAME = "personachat_self_original.json"


class FedPERSONA(FedDataset):
    def __init__(self, tokenizer, num_candidates, max_history,
                 personality_permutations, *args, **kwargs):
        self.tokenizer = tokenizer
        self.num_candidates = num_candidates
        self.max_history = max_history
        self.personality_permutations = personality_permutations
        super().__init__(*args, **kwargs)
        if self.type == "val":
            with open(self.validation_fn()) as f:
                self.raw_val_set = json.load(f)
        self._rng = random.Random(kwargs.get("seed", 0))
        self._client_cache = {}

    # --- partitioning (reference fed_persona.py:46-75) -------------------

    @property
    def data_per_client(self):
        # cached: at natural scale (17,568 clients) this is an
        # O(#dialogs) reduction, and __getitem__ consults it per item
        # in iid mode
        if self._dpc_cache is not None:
            return self._dpc_cache
        if self.do_iid:
            n = len(self)
            upc = (np.ones(self.num_clients, dtype=int) * n
                   // self.num_clients)
            extra = n % self.num_clients
            if extra:
                upc[self.num_clients - extra:] += 1
            self._dpc_cache = upc
            return upc
        # utterances per client = segmented sum of utterances-per-
        # dialog over each client's dialog span
        upd_cumsum = np.hstack(
            [[0], np.cumsum(self.train_utterances_per_dialog)])
        spans = np.hstack([[0], np.cumsum(self.dialogs_per_client)])
        self._dpc_cache = np.diff(upd_cumsum[spans])
        return self._dpc_cache

    @property
    def num_clients(self):
        if self.do_iid:
            return (self._num_clients if self._num_clients is not None
                    else len(self.dialogs_per_client))
        return len(self.dialogs_per_client)

    def _load_meta(self, train):
        with open(self.stats_fn()) as f:
            stats = json.load(f)
        self.dialogs_per_client = stats["dialogs_per_client"]
        self.train_utterances_per_dialog = \
            stats["train_utterances_per_dialog"]
        self.val_utterances_per_dialog = \
            stats["val_utterances_per_dialog"]
        # index->dialog->client lookups are done per __getitem__; at
        # 17,568 clients / 130k dialogs the cumsums must not be
        # recomputed per access
        self._train_upd_cumsum = np.cumsum(
            self.train_utterances_per_dialog)
        self._dialog_cumsum = np.cumsum(self.dialogs_per_client)
        self._val_upd_cumsum = np.cumsum(
            self.val_utterances_per_dialog)
        self._dpc_cache = None
        self._iid_dpc_cumsum = None

    def __len__(self):
        if self.type == "train":
            return int(sum(self.train_utterances_per_dialog))
        return int(sum(self.val_utterances_per_dialog))

    # --- split (reference fed_persona.py:87-167) -------------------------

    def prepare_datasets(self, download=False):
        os.makedirs(self.dataset_dir, exist_ok=True)
        raw_path = os.path.join(self.dataset_dir, RAW_NAME)
        if not os.path.exists(raw_path):
            raise FileNotFoundError(
                f"{raw_path} not found (nothing is downloaded by the "
                "port); place the personachat archive there or "
                "use generate_synthetic_personachat()")
        with open(raw_path) as f:
            raw = json.load(f)

        val_set = raw["valid"]
        val_upd = [len(d["utterances"]) for d in val_set]

        client_datasets = defaultdict(list)
        for dialog in raw["train"]:
            client_datasets[tuple(dialog["personality"])].append(dialog)

        personalities = list(client_datasets.keys())
        dialogs_per_client, train_upd = [], []
        for p in personalities:
            dialogs = client_datasets[p]
            dialogs_per_client.append(len(dialogs))
            train_upd.extend(len(d["utterances"]) for d in dialogs)

        for cid, p in enumerate(personalities):
            _dump_json(self.client_fn(cid), client_datasets[p])
        _dump_json(self.validation_fn(), val_set)
        _dump_json(self.stats_fn(),
                   {"dialogs_per_client": dialogs_per_client,
                    "train_utterances_per_dialog": train_upd,
                    "val_utterances_per_dialog": val_upd})

    # --- items (reference fed_persona.py:180-260) ------------------------

    def __getitem__(self, idx):
        if self.type == "train":
            return self._get_train_item_full(idx)
        return self._get_val_item_full(idx)

    def _get_train_item_full(self, idx):
        orig_idx = idx
        if self.do_iid:
            idx = self.iid_shuffle[idx]

        cumsum = self._train_upd_cumsum
        dialog_id = int(np.searchsorted(cumsum, idx, side="right"))
        idx_within_dialog = int(idx - (cumsum[dialog_id - 1]
                                       if dialog_id else 0))

        cumsum = self._dialog_cumsum
        client_id = int(np.searchsorted(cumsum, dialog_id,
                                        side="right"))
        idx_within_client = int(dialog_id - (cumsum[client_id - 1]
                                             if client_id else 0))

        dataset = self._load_client(client_id)
        dialog = dataset[idx_within_client]
        personality = list(dialog["personality"])
        utterance = dialog["utterances"][idx_within_dialog]

        # the reference shuffles P times and returns only the last
        # tokenization (fed_persona.py:231-241 — model_inputs is built
        # then discarded); same semantics, but tokenize just once
        for _ in range(self.personality_permutations):
            self._rng.shuffle(personality)
        model_input = self.utterance_to_input(personality, utterance)

        if self.do_iid:
            if self._iid_dpc_cumsum is None:
                self._iid_dpc_cumsum = np.cumsum(self.data_per_client)
            client_id = int(np.searchsorted(self._iid_dpc_cumsum,
                                            orig_idx, side="right"))
        return (client_id,) + model_input

    def _get_val_item_full(self, idx):
        cumsum = self._val_upd_cumsum
        dialog_id = int(np.searchsorted(cumsum, idx, side="right"))
        idx_within = int(idx - (cumsum[dialog_id - 1]
                                if dialog_id else 0))
        dialog = self.raw_val_set[dialog_id]
        return (-1,) + self.utterance_to_input(
            list(dialog["personality"]),
            dialog["utterances"][idx_within])

    def _load_client(self, client_id):
        if client_id not in self._client_cache:
            if len(self._client_cache) > 256:
                self._client_cache.clear()
            with open(self.client_fn(client_id)) as f:
                self._client_cache[client_id] = json.load(f)
        return self._client_cache[client_id]

    def utterance_to_input(self, personality, utterance):
        history = utterance["history"][-(2 * self.max_history + 1):]
        candidates = utterance["candidates"]
        num_candidates = len(candidates)
        if self.num_candidates > 0 and self.type == "train":
            num_candidates = min(self.num_candidates, num_candidates)
        candidates = candidates[-num_candidates:]
        return raw_to_input(self.tokenizer, personality, history,
                            candidates)

    def client_fn(self, client_id):
        return os.path.join(self.dataset_dir,
                            f"client{client_id}.json")

    def validation_fn(self):
        return os.path.join(self.dataset_dir, "validation.json")


def tokenize_obj(obj, tokenizer):
    if isinstance(obj, str):
        return tokenizer.encode(obj)
    if isinstance(obj, dict):
        return {n: tokenize_obj(o, tokenizer) for n, o in obj.items()}
    return [tokenize_obj(o, tokenizer) for o in obj]


def raw_to_input(tokenizer, personality, history, candidates):
    """strings -> per-candidate model inputs
    (reference fed_persona.py:283-316)."""
    personality = tokenize_obj(personality, tokenizer)
    history = tokenize_obj(history, tokenizer)
    candidates = tokenize_obj(candidates, tokenizer)

    model_input = defaultdict(list)
    n = len(candidates)
    for j, candidate in enumerate(candidates):
        instance = build_input_from_segments(
            personality, history, candidate, tokenizer,
            lm_labels=(j == n - 1))
        for name, arr in instance.items():
            model_input[name].append(arr)
    model_input["mc_labels"] = n - 1
    return tuple(model_input[name] for name in MODEL_INPUTS)


def build_input_from_segments(persona, history, reply, tokenizer,
                              lm_labels=False, with_eos=True):
    """Serialize one (persona, history, reply) triple into the flat
    GPT-2 double-heads token protocol. The token streams must match
    the reference's (fed_persona.py:330-358 *semantics*) exactly,
    since checkpoints and eval numbers depend on them. Protocol, accumulated segment by segment:

    - header: ``<bos>`` + all persona sentences flattened, token type
      ``speaker1``;
    - one segment per dialog turn (history turns, then the reply, with
      ``<eos>`` appended when ``with_eos``). Each is prefixed with a
      speaker token chosen so the *reply* is always ``speaker2`` and
      speakers alternate backwards from it. The token *type* of turn t
      is ``speaker2`` for even t — by turn index, not by the prefixed
      speaker, so the two disagree for odd history lengths (the
      reference's index-parity quirk, kept as-is);
    - ``mc_token_ids``: index of the final token, where the MC head
      reads its summary;
    - ``lm_labels``: -1 (ignore) everywhere except, on the gold
      candidate (``lm_labels=True``), the reply tokens and eos — each
      predicted from its predecessor, so the speaker prefix gets -1.
    """
    bos, eos, speaker1, speaker2 = tokenizer.convert_tokens_to_ids(
        SPECIAL_TOKENS[:-1])

    input_ids = [bos]
    for sentence in persona:
        input_ids.extend(sentence)
    token_types = [speaker1] * len(input_ids)
    labels = [-1] * len(input_ids)

    turns = list(history)
    turns.append(list(reply) + ([eos] if with_eos else []))
    gold = len(turns) - 1
    for t, turn in enumerate(turns):
        prefix = speaker2 if (gold - t) % 2 == 0 else speaker1
        input_ids.append(prefix)
        input_ids.extend(turn)
        ttype = speaker2 if t % 2 == 0 else speaker1
        token_types.extend([ttype] * (len(turn) + 1))
        if lm_labels and t == gold:
            labels.append(-1)          # the speaker prefix
            labels.extend(turn)
        else:
            labels.extend([-1] * (len(turn) + 1))

    return {"input_ids": input_ids,
            "token_type_ids": token_types,
            "mc_token_ids": len(input_ids) - 1,
            "lm_labels": labels}


def persona_collate(records, num_candidates, max_seq_len, pad_id=0):
    """List of (client_id,)+MODEL_INPUTS tuples -> static-shape arrays:
    input_ids/token_type_ids/lm_labels (B, N, T), mc_token_ids (B, N),
    mc_labels (B,). Sequences beyond ``max_seq_len`` are truncated
    from the *front* (keeps the reply + eos, which carry the LM
    labels); lm_labels pad with -1 (reference pad values,
    fed_persona.py:379)."""
    B, N, T = len(records), num_candidates, max_seq_len
    out = {
        "input_ids": np.full((B, N, T), pad_id, np.int32),
        "token_type_ids": np.full((B, N, T), pad_id, np.int32),
        "lm_labels": np.full((B, N, T), -1, np.int32),
        "mc_token_ids": np.zeros((B, N), np.int32),
        "mc_labels": np.zeros((B,), np.int32),
        # 1.0 on real candidate slots; val consumers mask the MC
        # argmax with this so padded slots can never be predicted
        "cand_mask": np.zeros((B, N), np.float32),
    }
    client_ids = np.zeros((B,), np.int32)
    for b, rec in enumerate(records):
        cid, input_ids, mc_tok, lm_lab, mc_lab, tt = rec
        client_ids[b] = cid
        # if the record has more candidates than N (val items carry all
        # ~20), keep the LAST N — the gold candidate is always last by
        # construction (fed_persona.py:305), so the label stays N-1
        if len(input_ids) > N:
            input_ids, mc_tok = input_ids[-N:], mc_tok[-N:]
            lm_lab, tt = lm_lab[-N:], tt[-N:]
            mc_lab = N - 1
        out["mc_labels"][b] = mc_lab
        for j in range(min(N, len(input_ids))):
            seq = input_ids[j][-T:]
            ttj = tt[j][-T:]
            lab = lm_lab[j][-T:]
            L = len(seq)
            out["input_ids"][b, j, :L] = seq
            out["token_type_ids"][b, j, :L] = ttj
            out["lm_labels"][b, j, :L] = lab
            out["mc_token_ids"][b, j] = min(mc_tok[j], L - 1)
            out["cand_mask"][b, j] = 1.0
    return client_ids, out


def generate_learnable_personachat(path, word_list,
                                   num_personalities=1000,
                                   dialogs_per_personality=4,
                                   utterances_per_dialog=5,
                                   num_candidates=5,
                                   signature_size=24,
                                   num_val_dialogs=100,
                                   seed=0,
                                   val_from_train_sigs=False,
                                   distractor_disjoint=False):
    """Write a personachat-format archive with *learnable* structure,
    for convergence evidence where the real archive is unavailable
    (offline; reference fed_persona.py:23 downloads it from S3).

    Each personality draws a signature set of ``signature_size`` words
    from ``word_list``; its persona sentences, dialog turns, and gold
    replies all use only signature words, while distractor candidates
    are sentences from a *different* personality's signature. So:

    - the LM can cut NLL from ~ln(|word_list|) to ~ln(signature_size)
      by conditioning on the persona/history prefix;
    - the MC head is above chance iff it learns "the gold reply shares
      the prefix's vocabulary" — a relation, not a memorized string:
      validation dialogs use personalities (signature sets) never seen
      in training, so val PPL/accuracy measure the learned rule.

    ``val_from_train_sigs=True`` instead draws validation dialogs
    (fresh sentences) from the TRAINING personalities — the easier
    seen-persona tier: persona-vocabulary associations absorbed during
    training suffice, no cross-persona rule needed. Useful as a
    second evaluation split for a model trained on the default corpus
    (same word list + seed ⇒ identical train signatures).

    ``distractor_disjoint=True`` rejection-samples each distractor's
    source personality so its signature shares NO words with the gold
    signature (falls back to the least-overlapping candidate after 64
    tries). Without it, random signature collisions put gold-vocabulary
    words inside distractors, diluting the lexical-overlap signal the
    MC head must learn; with it the task's Bayes accuracy is 1.0 by a
    pure "candidate vocabulary ⊆ prefix vocabulary" rule. Off by
    default so pre-existing seeds regenerate byte-identically.

    Gold candidate is last (reference convention, fed_persona.py:305).
    """
    rng = random.Random(seed)

    def make_persona():
        return rng.sample(word_list, signature_size)

    def sentence(sig):
        return " ".join(rng.choice(sig)
                        for _ in range(rng.randint(4, 8)))

    def pick_distractor_sig(gold_set, all_sigs):
        if not distractor_disjoint:
            return rng.choice(all_sigs)
        best, best_overlap = None, None
        for _ in range(64):
            cand = rng.choice(all_sigs)
            overlap = len(gold_set.intersection(cand))
            if overlap == 0:
                return cand
            if best_overlap is None or overlap < best_overlap:
                best, best_overlap = cand, overlap
        return best

    def dialog(sig, all_sigs):
        gold_set = set(sig)
        utterances = []
        history = [sentence(sig)]
        for _ in range(utterances_per_dialog):
            cands = [sentence(pick_distractor_sig(gold_set, all_sigs))
                     for _ in range(num_candidates - 1)]
            cands.append(sentence(sig))  # gold last
            utterances.append({"history": list(history),
                               "candidates": cands})
            history.append(sentence(sig))
            history.append(sentence(sig))
        return utterances

    data = {"train": [], "valid": []}
    train_sigs = [make_persona() for _ in range(num_personalities)]
    for sig in train_sigs:
        personality = [sentence(sig) for _ in range(3)]
        others = [s for s in train_sigs if s is not sig] or [sig]
        for _ in range(dialogs_per_personality):
            data["train"].append({"personality": personality,
                                  "utterances": dialog(sig, others)})
    n_val_sigs = max(1, num_val_dialogs // 4)
    if val_from_train_sigs:
        val_sigs = [train_sigs[rng.randrange(len(train_sigs))]
                    for _ in range(n_val_sigs)]
    else:
        val_sigs = [make_persona() for _ in range(n_val_sigs)]
    for i in range(num_val_dialogs):
        sig = val_sigs[i % len(val_sigs)]
        others = [s for s in val_sigs if s is not sig] or [sig]
        data["valid"].append({
            "personality": [sentence(sig) for _ in range(3)],
            "utterances": dialog(sig, others)})
    os.makedirs(path, exist_ok=True)
    _dump_json(os.path.join(path, RAW_NAME), data)


def _dump_json(path, obj):
    """``obj`` to ``path`` through a file of this process renamed into
    place: the ranks of a mesh run prepare one directory at once, and a
    reader never sees a file half written."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def generate_synthetic_personachat(path, num_personalities=8,
                                   dialogs_per_personality=2,
                                   utterances_per_dialog=3,
                                   num_candidates=2, seed=0):
    """Write a tiny synthetic personachat-format archive for offline
    tests/smoke (same JSON schema as the S3 original)."""
    rng = random.Random(seed)
    words = ["i", "like", "cats", "dogs", "music", "food", "sports",
             "reading", "travel", "coding", "you", "me", "the", "a"]

    def sentence():
        return " ".join(rng.choice(words)
                        for _ in range(rng.randint(3, 7)))

    def dialog():
        utterances = []
        history = [sentence()]
        for _ in range(utterances_per_dialog):
            utterances.append({
                "history": list(history),
                "candidates": [sentence()
                               for _ in range(num_candidates)],
            })
            history.append(sentence())
            history.append(sentence())
        return utterances

    data = {"train": [], "valid": []}
    for p in range(num_personalities):
        personality = [f"persona {p} " + sentence() for _ in range(3)]
        for _ in range(dialogs_per_personality):
            data["train"].append({"personality": personality,
                                  "utterances": dialog()})
    for _ in range(4):
        data["valid"].append({
            "personality": [sentence() for _ in range(3)],
            "utterances": dialog()})
    os.makedirs(path, exist_ok=True)
    _dump_json(os.path.join(path, RAW_NAME), data)
