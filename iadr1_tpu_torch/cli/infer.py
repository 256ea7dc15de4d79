"""Benchmark inference CLI (counterpart of iadr1_tpu/cli/infer.py).

Greedy decoding at temperature 0.0 with 512 max tokens by default, a
resumable answers JSON and the balanced-accuracy CSV.  Runs on the card
unless given ``--device cpu``.

Usage:
    python -m iadr1_tpu_torch.cli.infer --model-path /ckpts/qwen2vl-2b \
        --test-data data/Test/test_DAGM_format.json --image-dir /data \
        --output-dir results/DAGM --num-shot 0
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--test-data", required=True,
                        help="benchmark JSON (test_*_format.json)")
    parser.add_argument("--image-dir", default="",
                        help="root for relative image paths")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--num-shot", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--max-prompt-length", type=int, default=1024)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--temperature", type=float, default=None,
                        help="default: 0.0 (iad mode) / 0.7 (pretrain mode)")
    parser.add_argument("--mode", choices=["iad", "pretrain"], default="iad",
                        help="pretrain: base-checkpoint evaluation -- "
                        "'Please answer by yes or no' system prompt, "
                        "temperature 0.7, tag-free answer parsing")
    parser.add_argument("--max-pixels", type=int, default=480000)
    parser.add_argument("--patch-budget", type=int, default=4096)
    parser.add_argument("--template", default=None)
    parser.add_argument("--attention", default="auto")
    parser.add_argument("--normal-flag", default="good")
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--quant", choices=["none", "int8", "int4", "nf4"],
                        default="none",
                        help="weight-only quantization (models/quant.py): "
                        "int8 per-channel, int4/nf4 packed blockwise")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' runs the plain "
                        "PyTorch path")
    args = parser.parse_args(argv)

    import torch
    from transformers import AutoTokenizer

    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.eval.harness import (
        PRETRAIN_SYSTEM_PROMPT,
        build_messages,
        load_benchmark,
        run_benchmark,
        summarize,
    )
    from iadr1_tpu_torch.eval.mcq import extract_option_answer_pretrain
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
    from iadr1_tpu_torch.models.quant import quantize_tree
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained

    device = resolve_device(args.device)
    bundle = bundle_from_pretrained(args.model_path, attention=args.attention)
    params = bundle.convert_hf(load_safetensors_path(args.model_path),
                               dtype=torch.bfloat16, device=device)
    if args.quant != "none":
        params = quantize_tree(params, fmt=args.quant)
    tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    template = get_template(args.template or bundle.template)

    pretrain = args.mode == "pretrain"
    temperature = args.temperature
    if temperature is None:
        temperature = 0.7 if pretrain else 0.0
    gen = VLMGenerator(
        bundle, params, tokenizer, template,
        GeneratorConfig(
            max_prompt_length=args.max_prompt_length,
            max_new_tokens=args.max_new_tokens,
            temperature=temperature,
            batch_size=args.batch_size,
            patch_budget=args.patch_budget,
            max_pixels=args.max_pixels,
        ),
        device=device,
    )

    items = load_benchmark(args.test_data, num_shot=args.num_shot)
    if args.max_samples:
        items = items[: args.max_samples]

    def generate_fn(batch_items):
        requests = []
        for item in batch_items:
            images = [
                os.path.join(args.image_dir, p) for p in item.few_shot
            ] + [os.path.join(args.image_dir, item.image)]
            messages = build_messages(
                item,
                system_prompt=PRETRAIN_SYSTEM_PROMPT if pretrain else None,
            )
            requests.append({"messages": messages, "images": images})
        return gen.generate(requests)

    os.makedirs(args.output_dir, exist_ok=True)
    shot = args.num_shot
    answers_path = os.path.join(args.output_dir, f"answers_{shot}_shot.json")
    run_benchmark(
        items, generate_fn, answers_path, batch_size=args.batch_size,
        answer_extractor=extract_option_answer_pretrain if pretrain else None,
    )
    print(summarize(answers_path, normal_flag=args.normal_flag).to_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
