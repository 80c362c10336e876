"""Synthetic LMaaS applications (paper §IV-A): six applications, eight
tasks (MT and CT have two directions each), with per-task ground-truth
generation-length models calibrated to reproduce the paper's observation —
strong positive correlation between user-input length and generation
length (Pearson > 0.8 for most tasks, Table I / Fig 2).

The generator also plants *user-level semantic* signal: a latent verbosity
register realized as actual words in the input, scaling the generated
length — this is what USIN (user-input semantics) picks up over INST.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.types import Request
from repro_torch.workload.tokenizer import token_count

_WORDS = ("data model train code line fix bug text word sent page file "
          "path node tree graph list map set queue stack heap sort hash "
          "loop call func class type var expr test case run time cost "
          "mem disk net user app task item plan note memo report draft "
          "table chart field form query index key value row col cell").split()

_VERBOSITY = {
    # register -> (marker words planted in the input, gen-length multiplier)
    "terse": (["brief", "short", "succinct"], 0.80),
    "plain": ([], 1.0),
    "verbose": (["detailed", "thorough", "elaborate"], 1.25),
}


@dataclasses.dataclass(frozen=True)
class TaskModel:
    app: str
    task: str
    instruction: str
    slope: float              # a: gen ~ a * UIL + b
    intercept: float          # b
    noise_frac: float         # lognormal-ish relative noise
    uil_range: Tuple[int, int]


TASKS: Dict[str, TaskModel] = {t.task: t for t in [
    TaskModel("mt", "mt:en-de", "Translate the following text to German:",
              1.10, 2, 0.08, (5, 400)),
    TaskModel("mt", "mt:en-zh", "Translate the following text to Chinese:",
              0.85, 2, 0.08, (5, 400)),
    TaskModel("gc", "gc", "Correct the grammar of the following text and "
              "output the corrected text:", 1.00, 1, 0.04, (5, 500)),
    TaskModel("td", "td", "Rewrite the following text to remove toxic "
              "language:", 0.92, 3, 0.15, (5, 300)),
    TaskModel("ct", "ct:cpp-py", "Translate the following C++ code to "
              "Python:", 0.68, 4, 0.10, (10, 600)),
    TaskModel("ct", "ct:py-cpp", "Translate the following Python code to "
              "C++:", 1.38, 6, 0.10, (10, 450)),
    TaskModel("bf", "bf", "Fix bugs in the following code and output the "
              "fixed code:", 1.02, 2, 0.05, (10, 600)),
    TaskModel("cc", "cc", "Write comments for the following code:",
              1.55, 15, 0.22, (10, 350)),
]}

APP_NAMES = {"mt": "machine translation", "gc": "grammar correction",
             "td": "text detoxification", "ct": "code translation",
             "bf": "bug fixing", "cc": "code comment"}


def make_request(task_id: str, rng: np.random.Generator,
                 max_len: int = 1024, max_gen: int = 1024) -> Request:
    tm = TASKS[task_id]
    uil = int(rng.integers(*tm.uil_range))
    register = rng.choice(list(_VERBOSITY), p=[0.25, 0.5, 0.25])
    markers, mult = _VERBOSITY[register]
    words = list(rng.choice(_WORDS, size=uil))
    # plant the register markers (user-level semantic signal)
    for m in markers:
        for _ in range(max(2, uil // 15)):
            words[int(rng.integers(0, uil))] = m
    text = " ".join(words[:uil])
    gen = tm.slope * uil + tm.intercept
    gen *= mult
    gen *= float(np.exp(rng.normal(0.0, tm.noise_frac)))
    gen = int(np.clip(round(gen), 1, max_gen))
    length = min(token_count(tm.instruction, bos=True) + uil, max_len)
    return Request(app=tm.app, task=tm.task, instruction=tm.instruction,
                   user_input=text, length=length, user_input_length=uil,
                   gen_length=gen)


def make_dataset(n_per_task: int, seed: int = 0,
                 tasks: List[str] | None = None) -> List[Request]:
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    for task_id in (tasks or list(TASKS)):
        out += [make_request(task_id, rng) for _ in range(n_per_task)]
    return out


def make_shared_prefix_dataset(n: int, *, n_apps: int = 1,
                               instr_words: int = 47, input_words: int = 8,
                               gen_length: int = 8,
                               seed: int = 0) -> List[Request]:
    """Shared-instruction workload for prefix-cache studies (DESIGN.md
    §10): ``n_apps`` distinct instruction templates of ``instr_words``
    words each (long app prompts — few-shot templates, style guides —
    are where per-app prefix sharing pays), requests assigned
    round-robin with fresh ``input_words``-word user inputs.  With one
    app every admission after the first is a prefix-cache hit; with
    ``n_apps == n`` every admission misses."""
    rng = np.random.default_rng(seed)
    instructions = [" ".join(rng.choice(_WORDS, size=instr_words))
                    for _ in range(n_apps)]
    out: List[Request] = []
    for i in range(n):
        app = i % n_apps
        text = " ".join(rng.choice(_WORDS, size=input_words))
        out.append(Request(
            app=f"shared{app}", task=f"shared{app}",
            instruction=instructions[app], user_input=text,
            length=instr_words + 1 + input_words,
            user_input_length=input_words, gen_length=gen_length,
            predicted_gen_length=gen_length))
    return out


def make_shared_head_dataset(n: int, *, n_apps: int = 3,
                             head_words: int = 31, tail_words: int = 16,
                             input_words: int = 8, gen_length: int = 8,
                             seed: int = 0) -> List[Request]:
    """Shared-head template *family* for radix prefix-cache studies
    (DESIGN.md §11): ``n_apps`` distinct instruction templates that all
    begin with the same ``head_words``-word preamble (a few-shot prompt,
    a style guide) and diverge into per-app ``tail_words``-word tails.
    Requests are assigned round-robin.

    This is the workload a content-keyed exact-match prefix cache
    could not serve: no two templates are equal, so every admission
    missed — while the radix tree shares the common head across all
    ``n_apps`` apps and re-prefills only tail + user input."""
    rng = np.random.default_rng(seed)
    head = " ".join(rng.choice(_WORDS, size=head_words))
    instructions = [f"{head} " + " ".join(rng.choice(_WORDS,
                                                     size=tail_words))
                    for _ in range(n_apps)]
    out: List[Request] = []
    for i in range(n):
        app = i % n_apps
        text = " ".join(rng.choice(_WORDS, size=input_words))
        out.append(Request(
            app=f"head{app}", task=f"head{app}",
            instruction=instructions[app], user_input=text,
            length=head_words + tail_words + 1 + input_words,
            user_input_length=input_words, gen_length=gen_length,
            predicted_gen_length=gen_length))
    return out


def pearson(requests: List[Request]) -> float:
    x = np.array([r.user_input_length for r in requests], np.float64)
    y = np.array([r.gen_length for r in requests], np.float64)
    if x.std() == 0 or y.std() == 0:
        return 0.0
    return float(np.corrcoef(x, y)[0, 1])
