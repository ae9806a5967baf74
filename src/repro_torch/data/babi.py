"""Synthetic bAbI-style QA generator (paper SSVI-A workload shape); the
port's copy of ``repro.data.babi``, numpy only and bit-equal for the same
seeds.

Task family mirrors bAbI task 1 ("single supporting fact"): a story of
"<actor> moved to <place>." statements followed by "Where is <actor>?".
The answer is the most recent place for that actor — exactly the
content-based retrieval the attention hop must learn, and the setting of
the paper's Figure 2 example.

Vocabulary layout: 0 = PAD, then actors, places, verbs, question words.
Everything is already tokenized (ints); no text processing needed.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class BabiTask(NamedTuple):
    vocab_size: int
    num_actors: int
    num_places: int
    max_sentences: int
    max_words: int
    answer_offset: int          # token id of place 0 (answers are places)


def make_task(num_actors: int = 12, num_places: int = 12,
              max_sentences: int = 50, max_words: int = 8) -> BabiTask:
    # 0=PAD, 1..A actors, A+1..A+P places, then 4 verbs + 2 question words
    vocab = 1 + num_actors + num_places + 6
    return BabiTask(vocab, num_actors, num_places, max_sentences, max_words,
                    answer_offset=1 + num_actors)


def generate_babi(task: BabiTask, batch: int, num_statements: int,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """Returns sentences [B, n, J], question [B, J], answer [B] (token id).

    ``num_statements`` <= task.max_sentences controls n — the paper's
    search-set size knob.
    """
    assert num_statements <= task.max_sentences
    rng = np.random.default_rng(seed)
    A, P = task.num_actors, task.num_places
    verb0 = 1 + A + P                       # 4 verbs: moved/went/ran/walked
    q_who = verb0 + 4                       # "where"
    q_is = verb0 + 5                        # "is"

    sentences = np.zeros((batch, task.max_sentences, task.max_words),
                         np.int32)
    question = np.zeros((batch, task.max_words), np.int32)
    answer = np.zeros((batch,), np.int32)

    unique = A >= num_statements
    for b in range(batch):
        last_place = {}
        # unique actors (paper Fig. 2 setting: pure content lookup) when
        # the vocabulary allows; otherwise repeats (requires the temporal
        # encoding to resolve "most recent")
        if unique:
            actors = rng.choice(A, size=num_statements, replace=False)
        else:
            actors = rng.integers(0, A, size=num_statements)
        for s in range(num_statements):
            actor = int(actors[s])
            place = int(rng.integers(0, P))
            verb = int(rng.integers(0, 4))
            sentences[b, s, 0] = 1 + actor
            sentences[b, s, 1] = verb0 + verb
            sentences[b, s, 2] = task.answer_offset + place
            last_place[actor] = place
        # ask about an actor that appeared
        actor = int(rng.choice(list(last_place.keys())))
        question[b, 0] = q_who
        question[b, 1] = q_is
        question[b, 2] = 1 + actor
        answer[b] = task.answer_offset + last_place[actor]
    return {"sentences": sentences, "question": question, "answer": answer}
