"""VLM generation facade: messages + images -> completion strings
(counterpart of iadr1_tpu/eval/generator.py).

Fixed prompt length, patch budget and batch: requests are encoded on the
host (template, image preprocessing, M-RoPE grids), collated into one
left-padded batch on the device and handed to the RolloutEngine.

Two departures from the JAX generator, both where it goes wrong: a leading
``system`` message becomes the template's system block (the JAX template
rejects the role), and a prompt that holds image tokens and exceeds
``max_prompt_length`` raises instead of losing its left end (a cut inside
or before an image run scatters the image features onto the wrong
tokens).  A text-only prompt is still cut from the left.  PaliGemma's
image runs go ahead of the encoded ids (``prepend_image_tokens``); such a
prompt holds image tokens, so it is never cut either (the JAX generator
cuts it from the left, the image run first: ROADMAP C.R3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from iadr1_tpu_torch.core.device import resolve_device
from iadr1_tpu_torch.data.mm import expand_image_tokens, prepend_image_tokens
from iadr1_tpu_torch.train.rollout import RolloutEngine, SamplingConfig
from iadr1_tpu_torch.vision.mrope import bundle_mrope_positions


@dataclasses.dataclass
class GeneratorConfig:
    max_prompt_length: int = 1024
    max_new_tokens: int = 512
    temperature: float = 0.0          # eval default (greedy)
    top_p: float = 0.8
    top_k: int = 0
    batch_size: int = 4
    patch_budget: int = 4096
    min_pixels: int = 56 * 56
    max_pixels: int = 480000
    seed: int = 0


def _pad_id(tokenizer) -> int:
    # as the JAX generator: a pad id of 0 also falls back to EOS
    return tokenizer.pad_token_id or tokenizer.eos_token_id


class VLMGenerator:
    def __init__(self, bundle, params, tokenizer, template,
                 cfg: GeneratorConfig, device=None):
        self.bundle = bundle
        self.params = params
        self.tokenizer = tokenizer
        self.template = template
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        sampling = SamplingConfig(
            max_new_tokens=cfg.max_new_tokens, temperature=cfg.temperature,
            top_p=cfg.top_p, top_k=cfg.top_k,
            eos_token_id=tokenizer.eos_token_id, pad_token_id=_pad_id(tokenizer),
        )
        self.engine = RolloutEngine(
            bundle, sampling,
            max_len=cfg.max_prompt_length + cfg.max_new_tokens,
            device=self.device)

    def update_params(self, params) -> None:
        """Swap the weights (e.g. the newest GRPO policy); no copy."""
        self.params = params

    def _encode_request(self, messages, images):
        """-> (prompt_ids, patches list, grids list)."""
        system = None
        if messages and messages[0]["role"] == "system":
            system, messages = messages[0]["content"], messages[1:]
        patches, grids, seqlens = [], [], []
        for img in images or []:
            from PIL import Image

            pil = Image.open(img) if isinstance(img, str) else img
            flat, grid, seqlen = self.bundle.preprocess_image(
                pil, min_pixels=self.cfg.min_pixels,
                max_pixels=self.cfg.max_pixels)
            patches.append(flat)
            grids.append(grid)
            seqlens.append(seqlen)
        if self.bundle.multimodal and seqlens:
            messages = expand_image_tokens(messages, seqlens,
                                           self.template.mm_style,
                                           self.template.image_token)
        else:
            messages = [{**m, "content": m["content"].replace("<image>", "")}
                        for m in messages]
        ids = self.template.encode_prompt(self.tokenizer, messages, system)
        if seqlens and self.template.mm_style == "paligemma":
            ids, _ = prepend_image_tokens(ids, None, seqlens,
                                          self.bundle.cfg.image_token_id)
        P = self.cfg.max_prompt_length
        if len(ids) > P and getattr(self.bundle.cfg, "image_token_id",
                                    None) in ids:
            raise ValueError(
                f"VLM prompt ({len(ids)} tokens) exceeds "
                f"max_prompt_length={P}; raise max_prompt_length or lower "
                "max_pixels")
        return ids[-P:], patches, grids

    def _collate(self, encoded) -> dict:
        """Encoded requests -> one left-padded batch of device tensors."""
        P, B = self.cfg.max_prompt_length, self.cfg.batch_size
        input_ids = np.full((B, P), _pad_id(self.tokenizer), np.int64)
        mask = np.zeros((B, P), np.int64)
        patches_list, grids = [], []
        for i, (ids, patches, grid) in enumerate(encoded):
            input_ids[i, P - len(ids):] = ids
            mask[i, P - len(ids):] = 1
            patches_list.extend(patches)
            grids.extend(grid)
        arrays = {"input_ids": input_ids, "attention_mask": mask}
        cfg = self.bundle.cfg
        if getattr(cfg, "text", cfg).mrope_section is not None:
            arrays["position_ids"], arrays["mrope_deltas"] = (
                bundle_mrope_positions(cfg, input_ids, grids,
                                       attention_mask=mask))
        if self.bundle.multimodal:
            arrays.update(self.bundle.vision_arrays(
                input_ids, patches_list, grids, self.cfg.patch_budget))
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in arrays.items()}

    def generate(self, requests: list[dict]) -> list[str]:
        """requests: [{"messages": [...], "images": [paths or PIL]}] ->
        texts."""
        return self._generate_encoded(
            [self._encode_request(r["messages"], r.get("images"))
             for r in requests])

    def _generate_encoded(self, encoded: list) -> list[str]:
        """Encoded requests (``_encode_request``'s triples) -> texts, in
        batches of ``batch_size``; a short final batch is padded with dummy
        rows."""
        out: list[str] = []
        B = self.cfg.batch_size
        for i in range(0, len(encoded), B):
            chunk = list(encoded[i:i + B])
            n = len(chunk)
            while len(chunk) < B:
                chunk.append((chunk[0][0][:4], [], []))
            result = self.engine.generate(self.params, self._collate(chunk),
                                          self.generator)
            ids = result["completion_ids"].cpu().numpy()
            mask = result["completion_mask"].cpu().numpy().astype(bool)
            out.extend(self.tokenizer.batch_decode(
                [ids[b][mask[b]] for b in range(n)],
                skip_special_tokens=True))
        return out
