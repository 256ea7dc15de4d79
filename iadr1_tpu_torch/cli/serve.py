"""OpenAI-compatible API server CLI (counterpart of iadr1_tpu/cli/serve.py).
Runs on the card unless given ``--device cpu``.

Usage:
    python -m iadr1_tpu_torch.cli.serve --model-path /ckpts/qwen2vl-2b --port 8000
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--template", default=None)
    parser.add_argument("--max-prompt-length", type=int, default=2048)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--patch-budget", type=int, default=4096)
    parser.add_argument("--attention", default="auto")
    parser.add_argument("--quant", choices=["none", "int8"], default="none",
                        help="int8: weight-only quantization of the linear "
                        "kernels (models/quant.py); halves their resident "
                        "bytes, while each call dequantizes its kernel in "
                        "full, so a decode step is slower than bf16's")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' runs the plain "
                        "PyTorch path")
    args = parser.parse_args(argv)

    import torch
    from transformers import AutoTokenizer

    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
    from iadr1_tpu_torch.models.quant import quantize_tree, quantized_bytes
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained
    from iadr1_tpu_torch.serve.api import ChatServer

    device = resolve_device(args.device)
    bundle = bundle_from_pretrained(args.model_path, attention=args.attention)
    params = bundle.convert_hf(load_safetensors_path(args.model_path),
                               dtype=torch.bfloat16, device=device)
    if args.quant == "int8":
        params = quantize_tree(params)
        now, bf16 = quantized_bytes(params)
        print(f"int8 weight-only quant: {now / 1e6:.1f} MB "
              f"(bf16 would be {bf16 / 1e6:.1f} MB)")
    tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    template = get_template(args.template or bundle.template)
    generator = VLMGenerator(
        bundle, params, tokenizer, template,
        GeneratorConfig(
            max_prompt_length=args.max_prompt_length,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            batch_size=1,
            patch_budget=args.patch_budget,
        ),
        device=device,
    )
    server = ChatServer(generator, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{args.port}/v1")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
