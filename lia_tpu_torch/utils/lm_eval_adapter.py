"""lm-eval-harness adapter over the port's engine (port of
``lia_tpu/utils/lm_eval_adapter.py``).

The harness's three request types map onto the engine:

- ``loglikelihood`` → :meth:`InferenceEngine.score` (summed log-prob, is_greedy);
- ``loglikelihood_rolling`` → full-text scoring in windows, each conditioned
  on the eot token;
- ``generate_until`` → :meth:`InferenceEngine.generate`, cut at the first stop string.

:class:`LiaTPULM` is duck-typed (no ``lm_eval`` import), so it is tested
without the harness; :func:`make_lm_eval_model` subclasses the installed
harness's ``LM`` and raises ``ImportError`` where ``lm_eval`` is missing.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

from lia_tpu_torch.config import GenerationConfig


class LiaTPULM:
    """The harness-independent core of lm-eval's model semantics."""

    def __init__(
        self,
        engine: Any,  # lia_tpu_torch InferenceEngine
        tokenizer: Any,  # HF-style: .encode/.decode, .eos_token_id
        batch_size: int = 8,
        max_length: int = 2048,
        max_gen_toks: int = 256,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.max_gen_toks = max_gen_toks

    # -- tokenization ------------------------------------------------------

    def tok_encode(self, s: str) -> List[int]:
        return list(self.tokenizer.encode(s, add_special_tokens=False))

    def tok_decode(self, ids: Sequence[int]) -> str:
        return self.tokenizer.decode(list(ids))

    @property
    def eot_token_id(self) -> int:
        return int(getattr(self.tokenizer, "eos_token_id", 0) or 0)

    def _encode_pair(self, context: str, continuation: str) -> Tuple[List[int], List[int]]:
        """Harness convention: whole-string encode, split at the context length
        (robust to tokenizers that merge across the boundary)."""
        n_spaces = len(context) - len(context.rstrip())
        if n_spaces > 0:  # trailing context whitespace belongs to the continuation
            continuation = context[-n_spaces:] + continuation
            context = context[:-n_spaces]
        whole = self.tok_encode(context + continuation)
        ctx = self.tok_encode(context)
        return whole[: len(ctx)], whole[len(ctx):]

    # -- request types -----------------------------------------------------

    def loglikelihood_pairs(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[Tuple[float, bool]]:
        """[(context, continuation)] → [(sum log-prob, is_greedy)]."""
        enc: List[Tuple[List[int], List[int]]] = []
        for context, continuation in pairs:
            if context == "":
                ctx_ids: List[int] = [self.eot_token_id]
                cont_ids = self.tok_encode(continuation)
            else:
                ctx_ids, cont_ids = self._encode_pair(context, continuation)
            # truncate from the left so ctx+cont fits the model window
            total = len(ctx_ids) + len(cont_ids)
            if total > self.max_length:
                ctx_ids = ctx_ids[-(self.max_length - len(cont_ids)):]
            enc.append((ctx_ids, cont_ids))

        out: List[Tuple[float, bool]] = []
        for i in range(0, len(enc), self.batch_size):
            chunk = enc[i : i + self.batch_size]
            ll, greedy = self.engine.score(
                [c for c, _ in chunk], [t for _, t in chunk]
            )
            out.extend((float(l), bool(g)) for l, g in zip(ll, greedy))
        return out

    def loglikelihood_rolling_texts(self, texts: Sequence[str]) -> List[float]:
        """Full-text log-likelihood via non-overlapping max_length windows
        (the harness's word-perplexity request; each window conditions on the
        eot token like an empty-context record)."""
        out: List[float] = []
        for s in texts:
            ids = self.tok_encode(s)
            total = 0.0
            for w0 in range(0, len(ids), self.max_length - 1):
                window = ids[w0 : w0 + self.max_length - 1]
                if not window:
                    continue
                ll, _ = self.engine.score([[self.eot_token_id]], [window])
                total += float(ll[0])
            out.append(total)
        return out

    def generate_until_pairs(
        self, pairs: Sequence[Tuple[str, dict]]
    ) -> List[str]:
        """[(context, {"until": [...], "max_gen_toks": n})] → completions."""
        out: List[str] = []
        for i in range(0, len(pairs), self.batch_size):
            chunk = pairs[i : i + self.batch_size]
            prompts = []
            for context, kw in chunk:
                ids = self.tok_encode(context)[-self.max_length :]
                prompts.append(ids if ids else [self.eot_token_id])
            max_new = max(
                int(kw.get("max_gen_toks", self.max_gen_toks)) for _, kw in chunk
            )
            gen = GenerationConfig(
                max_new_tokens=max_new,
                eos_token_id=self.eot_token_id,
                pad_token_id=self.engine.cfg.pad_token_id,
            )
            res = self.engine.generate(prompts, gen)
            for (context, kw), row in zip(chunk, res.sequences):
                text = self.tok_decode([int(t) for t in row])
                for stop in kw.get("until", []) or []:
                    cut = text.find(stop)
                    if cut >= 0:
                        text = text[:cut]
                out.append(text)
        return out


def make_lm_eval_model(engine, tokenizer, **kw):
    """An lm_eval ``LM`` instance over ``engine``::

        import lm_eval
        lm = make_lm_eval_model(engine, tokenizer)
        results = lm_eval.simple_evaluate(model=lm, tasks=["lambada_openai"])

    Raises ``ImportError`` where ``lm_eval`` is not installed."""
    try:
        from lm_eval.api.model import LM
    except ImportError as e:
        raise ImportError("make_lm_eval_model needs lm_eval (lm-eval-harness), which is not installed; "
                          "LiaTPULM runs the same requests without it") from e

    core = LiaTPULM(engine, tokenizer, **kw)

    class _LM(LM):
        def loglikelihood(self, requests):
            return core.loglikelihood_pairs([r.args for r in requests])

        def loglikelihood_rolling(self, requests):
            return core.loglikelihood_rolling_texts([r.args[0] for r in requests])

        def generate_until(self, requests):
            return core.generate_until_pairs([r.args for r in requests])

    return _LM()
