# Verbatim copy of theoremsearch_tpu/slogans/client.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Provider-pluggable LLM client for slogan generation.

The reference is hard-wired to AWS Bedrock invoke_model with DeepSeek
models and $/token from response headers (ec2/generate_slogans/
slogans.py:69-101, models.py:1-12). Here the provider is an interface:

- BedrockClient: boto3 path, gated on boto3 + credentials being present;
- LiteLLMClient: any litellm-supported provider, gated on litellm;
- OfflineStubClient: deterministic extractive summarizer so the full
  pipeline (catalog -> slogans -> embeddings -> index -> serve) runs
  hermetically in this zero-egress environment and in CI.

All clients return (text, input_tokens, output_tokens, cost_usd).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Protocol

# per-1k-token pricing, as in the reference registry (models.py:1-12)
MODELS = {
    "DeepSeek-R1": {
        "model_id": "us.deepseek.r1-v1:0",
        "input_token_cost": 0.00135 / 1000,
        "output_token_cost": 0.0054 / 1000,
    },
    "DeepSeek-V3.1": {
        "model_id": "deepseek.v3-v1:0",
        "input_token_cost": 0.00058 / 1000,
        "output_token_cost": 0.00168 / 1000,
    },
    "offline-stub": {
        "model_id": "offline-stub",
        "input_token_cost": 0.0,
        "output_token_cost": 0.0,
    },
}


@dataclass
class Completion:
    text: str | None
    input_tokens: int
    output_tokens: int
    cost_usd: float


class LLMClient(Protocol):
    def complete(self, instructions: list[str], payload: dict, temperature: float) -> Completion: ...


class OfflineStubClient:
    """Deterministic extractive 'slogan': strips LaTeX from the theorem
    body and keeps the first sentences. Zero cost, zero network."""

    model_name = "offline-stub"

    def __init__(self, max_sentences: int = 4):
        self.max_sentences = max_sentences

    def complete(self, instructions, payload, temperature) -> Completion:
        body = payload.get("theorem_body") or next(iter(payload.values()), "")
        text = _strip_latex(str(body))
        sentences = re.split(r"(?<=[.!?])\s+", text)
        slogan = " ".join(sentences[: self.max_sentences]).strip() or text[:300]
        n_in = len(json.dumps(payload)) // 4
        n_out = len(slogan) // 4
        return Completion(slogan, n_in, n_out, 0.0)


class BedrockClient:
    """AWS Bedrock invoke_model (chat-completions payload shape)."""

    def __init__(self, model_name: str, region: str | None = None):
        import boto3  # gated import

        self.model = MODELS[model_name]
        self.model_name = model_name
        self.brc = boto3.client("bedrock-runtime", region_name=region)

    def complete(self, instructions, payload, temperature) -> Completion:
        body = {
            "messages": [
                # content must be a STRING in the chat-completions schema
                # (instructions arrive as a list of lines — same join as
                # the litellm client)
                {"role": "user", "content": "\n".join(instructions)
                 if isinstance(instructions, (list, tuple)) else str(instructions)},
                {"role": "user", "content": json.dumps(payload)},
            ],
            "max_tokens": 1024,
            "temperature": temperature,
        }
        res = self.brc.invoke_model(
            modelId=self.model["model_id"],
            body=json.dumps(body),
            accept="application/json",
            contentType="application/json",
        )
        out = json.loads(res["body"].read())
        headers = res["ResponseMetadata"]["HTTPHeaders"]
        text = out["choices"][0]["message"]["content"]
        n_in = int(headers.get("x-amzn-bedrock-input-token-count", 0))
        n_out = int(headers.get("x-amzn-bedrock-output-token-count", 0))
        cost = n_in * self.model["input_token_cost"] + n_out * self.model["output_token_cost"]
        return Completion(text.strip() if text else None, n_in, n_out, cost)


class LiteLLMClient:
    """Any litellm-routable model (the reference's slogan-quality judge
    uses litellm, ec2/tests/slogan_quality/__main__.py)."""

    def __init__(self, model_name: str):
        import litellm  # gated import

        self._litellm = litellm
        self.model_name = model_name

    def complete(self, instructions, payload, temperature) -> Completion:
        res = self._litellm.completion(
            model=self.model_name,
            messages=[
                {"role": "system", "content": "\n".join(instructions)},
                {"role": "user", "content": json.dumps(payload)},
            ],
            temperature=temperature,
            max_tokens=1024,
        )
        text = res.choices[0].message.content
        usage = getattr(res, "usage", None)
        n_in = getattr(usage, "prompt_tokens", 0) or 0
        n_out = getattr(usage, "completion_tokens", 0) or 0
        spec = MODELS.get(self.model_name, MODELS["offline-stub"])
        cost = n_in * spec["input_token_cost"] + n_out * spec["output_token_cost"]
        return Completion(text.strip() if text else None, n_in, n_out, cost)


def get_client(model_name: str = "offline-stub", provider: str | None = None) -> LLMClient:
    """Resolve a client; falls back to the offline stub when the requested
    provider's dependencies/credentials are unavailable."""
    if provider == "bedrock" or (provider is None and model_name in ("DeepSeek-R1", "DeepSeek-V3.1")):
        try:
            return BedrockClient(model_name)
        except Exception:
            return OfflineStubClient()
    if provider == "litellm":
        try:
            return LiteLLMClient(model_name)
        except Exception:
            return OfflineStubClient()
    return OfflineStubClient()


_MATH_RE = re.compile(r"\$\$.*?\$\$|\$[^$]*\$|\\\[.*?\\\]|\\\(.*?\\\)", re.DOTALL)
_CMD_RE = re.compile(r"\\[A-Za-z@]+(\[[^\]]*\])?(\{[^{}]*\})*")


def _strip_latex(text: str) -> str:
    text = _MATH_RE.sub(" [math] ", text)
    text = _CMD_RE.sub(" ", text)
    text = text.replace("{", " ").replace("}", " ")
    return re.sub(r"\s+", " ", text).strip()
