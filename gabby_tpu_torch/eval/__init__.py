from gabby_tpu_torch.eval.ppl import evaluate_ppl, ppl_from_tokens  # noqa: F401
