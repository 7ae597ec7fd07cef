"""Per-model prompt templating: (system, prompt) → the string the model sees.

Ollama applies a model-family-specific template before llama.cpp tokenizes
(the reference relies on this implicitly at every `ollama.generate(system=...,
prompt=...)` call site — reference `FastAPI/app.py:85-90,105-111`). Getting
the template wrong silently degrades SQL quality (SURVEY.md §7 "hard parts"),
so templates are explicit, named, and unit-tested here.
"""

from __future__ import annotations

from typing import Callable, Dict

Template = Callable[[str, str], str]


def completion_template(system: str, prompt: str) -> str:
    """Plain system+prompt concatenation — the duckdb-nsql / base-model shape
    (a completion model fine-tuned to continue schema+question with SQL)."""
    if not system:
        return prompt
    return f"{system}\n\n{prompt}"


def llama3_chat_template(system: str, prompt: str) -> str:
    """Llama-3 instruct chat format (header/eot special-token strings; the
    HF tokenizer maps them to their special ids)."""
    parts = ["<|begin_of_text|>"]
    if system:
        parts.append(
            f"<|start_header_id|>system<|end_header_id|>\n\n{system}<|eot_id|>"
        )
    parts.append(
        f"<|start_header_id|>user<|end_header_id|>\n\n{prompt}<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>\n\n"
    )
    return "".join(parts)


def mistral_instruct_template(system: str, prompt: str) -> str:
    """Mistral [INST] format; system folds into the first instruction."""
    body = f"{system}\n\n{prompt}" if system else prompt
    return f"[INST] {body} [/INST]"


TEMPLATES: Dict[str, Template] = {
    "completion": completion_template,
    "llama3-chat": llama3_chat_template,
    "mistral-instruct": mistral_instruct_template,
}
