"""Benchmark scorers — the published metric definitions, reimplemented.

Each module reproduces one benchmark family's scoring rules as pure
functions over predictions, with heavyweight externals (mmdet detector,
CLIP color classifier, GPT judges) injected as callables so the pipelines
are unit-testable offline and swappable for the official models online.

  geneval  — object-detection rule scoring + task summary
             (reference eval/gen/geneval/evaluation/{evaluate_images,summary_scores}.py)
  mme      — per-task acc/acc+ score tables (eval/vlm/eval/mme/calculation.py)
  mmmu     — multi-choice/open answer parsing + per-subject accuracy
             (eval/vlm/eval/mmmu/eval_utils.py)
  mmbench  — option-letter extraction + circular consistency
             (eval/vlm/eval/mmbench/evaluate_mmbench.py)
  pope     — yes/no F1 (eval/vlm/eval/pope/eval_pope.py)
  vqa      — EvalAI soft accuracy / ANLS / relaxed / exact-match
             (eval/vlm/eval/vqa/{evaluate_vqa,textvqa_eval}.py)
  mmvp     — paired-question accuracy + option mapping
             (eval/vlm/eval/mmvp/evaluate_mmvp.py)
  mmvet    — GPT-grader protocol (<AND>/<OR> algebra, capability tables)
             + official results.json export (eval/vlm/eval/mmvet/*)
  judge    — generic GPT-judge workers: WISE WiScore and VIEScore/GEdit
             SC/PQ aggregation (eval/gen/wise/*, eval/gen/gedit/*)
"""

from bagel_tpu_torch.eval.scorers.geneval import (  # noqa: F401
    evaluate_sample as geneval_evaluate_sample,
    filter_detections as geneval_filter_detections,
    summarize as geneval_summarize,
)
from bagel_tpu_torch.eval.scorers.judge import (  # noqa: F401
    extract_wise_scores,
    gedit_summarize,
    run_judge,
    viescore_overall,
    wise_summarize,
    wiscore,
)
from bagel_tpu_torch.eval.scorers.mmbench import (  # noqa: F401
    extract_option_letter,
    mmbench_accuracy,
    mmbench_circular_accuracy,
)
from bagel_tpu_torch.eval.scorers.mme import mme_score  # noqa: F401
from bagel_tpu_torch.eval.scorers.mmmu import (  # noqa: F401
    eval_open_response,
    mmmu_accuracy,
    parse_multi_choice_response,
    parse_open_response,
)
from bagel_tpu_torch.eval.scorers.mmvet import (  # noqa: F401
    containment_score,
    export_results as mmvet_export_results,
    mmvet_score,
)
from bagel_tpu_torch.eval.scorers.mmvp import mmvp_score  # noqa: F401
from bagel_tpu_torch.eval.scorers.pope import pope_score  # noqa: F401
from bagel_tpu_torch.eval.scorers.vqa import (  # noqa: F401
    anls_score,
    exact_match_accuracy,
    normalize_answer,
    relaxed_accuracy,
    vqa_accuracy,
)
