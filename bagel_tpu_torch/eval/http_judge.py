"""HTTP judge adapter: plug a judge HTTP endpoint into any `--judge`
CLI slot (judge_scorer, vlm_runner).

The reference posts judge requests to the OpenAI API from inside each
scorer worker (eval/gen/wise/gpt_eval_mp.py:160-170, gedit/viescore/
mllm_tools/openai.py); here the judge is a deployment-side HTTP service
(any OpenAI-proxy or bespoke endpoint) and the scorers stay judge-agnostic.

Protocol: POST JSON {"prompt": str, "images": [base64 PNG/JPEG bytes...],
"model": str|null} -> {"text": str}. stdlib-only (urllib) so eval boxes
need no extra deps.

CLI usage (module-level `judge` reads the endpoint from the environment):
    BAGEL_JUDGE_URL=http://judge:8080/v1/judge \\
        python -m bagel_tpu_torch.eval.judge_scorer wise \\
        --results_dir results/wise --judge bagel_tpu_torch.eval.http_judge:judge
"""

from __future__ import annotations

import base64
import json
import os
import urllib.request
from typing import Callable, List, Optional


def make_http_judge(url: str, model: Optional[str] = None,
                    timeout: float = 120.0) -> Callable[[str, List[str]], str]:
    """Build a judge callable (prompt, image_paths) -> text posting to
    `url`. Raises on HTTP/connection errors — run_judge's retry/sentinel
    machinery owns failure policy, not the transport."""

    def judge(prompt: str, image_paths: List[str]) -> str:
        images = []
        for p in image_paths:
            with open(p, "rb") as f:
                images.append(base64.b64encode(f.read()).decode("ascii"))
        body = json.dumps(
            {"prompt": prompt, "images": images, "model": model}
        ).encode("utf-8")
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))["text"]

    return judge


def judge(prompt: str, image_paths: List[str]) -> str:
    """Env-configured entry point for `--judge bagel_tpu_torch.eval.http_judge:judge`."""
    url = os.environ.get("BAGEL_JUDGE_URL")
    if not url:
        raise RuntimeError("BAGEL_JUDGE_URL is not set")
    return make_http_judge(url, model=os.environ.get("BAGEL_JUDGE_MODEL"))(
        prompt, image_paths
    )
