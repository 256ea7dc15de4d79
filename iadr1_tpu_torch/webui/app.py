"""Single-page web UI server (stdlib http.server; the port's own copy of
iadr1_tpu/webui/app.py).

Counterpart of llamafactory/webui/interface.py create_ui/run_web_ui: a
training form, a live run monitor (loss curve + latest metrics), and a
chat box, served from one HTML page.  Gradio is replaced by ~100 lines of
vanilla HTML/JS talking to a JSON API:

* GET  /                -> the app page
* POST /api/train       -> launch a run (Runner.launch)
* GET  /api/progress    -> run state + trainer_log.jsonl records
* POST /api/abort       -> terminate the run
* POST /api/chat        -> chat with a checkpoint (lazy-loaded generator)

Training runs and the chat tab's generator run on the card unless told
``cpu`` (the form's ``device``, ``--device`` of ``main``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from iadr1_tpu_torch.webui.runner import Runner

PAGE = """<!DOCTYPE html>
<html><head><title>iadr1-tpu board</title><style>
body { font-family: sans-serif; margin: 2em; max-width: 60em; }
fieldset { margin-bottom: 1em; } label { display: inline-block; width: 11em; }
input, select { margin: 2px; width: 22em; } #log, #chatlog {
  white-space: pre-wrap; background: #f4f4f4; padding: 1em; min-height: 4em; }
</style></head><body>
<h1>iadr1-tpu board</h1>
<fieldset><legend>Train</legend>
<label>stage</label><select id="stage">
<option>sft</option><option>pt</option><option>grpo</option>
<option>dpo</option><option>kto</option><option>rm</option><option>ppo</option>
</select><br/>
<label>model_name_or_path</label><input id="model"/><br/>
<label>dataset</label><input id="dataset"/><br/>
<label>template</label><input id="template" value="qwen2_vl"/><br/>
<label>learning_rate</label><input id="lr" value="1e-5"/><br/>
<label>max_steps</label><input id="steps" value="100"/><br/>
<label>batch_size</label><input id="bs" value="8"/><br/>
<label>output_dir</label><input id="out" value="runs/webui"/><br/>
<button onclick="launch()">Start</button>
<button onclick="abort_()">Abort</button>
</fieldset>
<fieldset><legend>Progress</legend><div id="log">idle</div></fieldset>
<fieldset><legend>Chat</legend>
<input id="msg" style="width:40em"/><button onclick="chat()">Send</button>
<div id="chatlog"></div></fieldset>
<script>
async function api(path, body) {
  const opts = body ? {method: "POST", body: JSON.stringify(body)} : {};
  const r = await fetch(path, opts); return r.json();
}
async function launch() {
  const form = {stage: stage.value, model_name_or_path: model.value,
    dataset: dataset.value, template: template.value,
    learning_rate: lr.value, max_steps: steps.value, batch_size: bs.value,
    output_dir: out.value};
  log.textContent = JSON.stringify(await api("/api/train", form), null, 1);
  poll();
}
async function poll() {
  const p = await api("/api/progress");
  log.textContent = JSON.stringify(p, null, 1);
  if (p.state === "running") setTimeout(poll, 2000);
}
async function abort_() { await api("/api/abort", {}); poll(); }
async function chat() {
  const r = await api("/api/chat", {message: msg.value});
  chatlog.textContent += "> " + msg.value + "\\n" + r.response + "\\n";
  msg.value = "";
}
</script></body></html>
"""


class WebUIServer:
    def __init__(self, runner: Runner | None = None, chat_fn=None,
                 host: str = "127.0.0.1", port: int = 7860):
        """``chat_fn(message: str) -> str``: injected chat backend.  The
        default lazily builds a VLMGenerator from the form's model path on
        first use (webui/chatter.py WebChatModel analogue)."""
        self.runner = runner or Runner()
        self.chat_fn = chat_fn
        self.host, self.port = host, port
        self._httpd = None
        self._thread = None

    # --- API handlers ------------------------------------------------------

    def handle(self, method: str, path: str, body: dict) -> tuple[int, object]:
        if method == "GET" and path == "/":
            return 200, PAGE
        if method == "GET" and path == "/api/progress":
            return 200, self.runner.progress()
        if method == "POST" and path == "/api/train":
            try:
                info = self.runner.launch(body, dry_run=body.pop("dry_run", False))
                return 200, {"ok": True, **info}
            except (KeyError, ValueError, RuntimeError) as e:
                return 400, {"ok": False, "error": str(e)}
        if method == "POST" and path == "/api/abort":
            return 200, {"aborted": self.runner.abort()}
        if method == "POST" and path == "/api/chat":
            if self.chat_fn is None:
                return 400, {"error": "no chat backend configured; start "
                             "the server with --chat-model <path>"}
            return 200, {"response": self.chat_fn(body.get("message", ""))}
        return 404, {"error": f"no route {method} {path}"}

    # --- server ------------------------------------------------------------

    def _make_httpd(self):
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _respond(self, code, payload):
                if isinstance(payload, str):
                    data = payload.encode()
                    ctype = "text/html; charset=utf-8"
                else:
                    data = json.dumps(payload).encode()
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._respond(*ui.handle("GET", self.path, {}))

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._respond(400, {"error": "invalid JSON"})
                    return
                self._respond(*ui.handle("POST", self.path, body))

        return ThreadingHTTPServer((self.host, self.port), Handler)

    def start_background(self) -> int:
        self._httpd = self._make_httpd()
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def serve_forever(self):
        self._httpd = self._make_httpd()
        self.port = self._httpd.server_address[1]
        print(f"iadr1-tpu board at http://{self.host}:{self.port}")
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()


def create_server(runner=None, chat_fn=None, host="127.0.0.1", port=7860):
    return WebUIServer(runner=runner, chat_fn=chat_fn, host=host, port=port)


def _lazy_chat_fn(model_path: str, template_name: str | None,
                  max_new_tokens: int = 256, device=None):
    """A chat backend that builds a bf16 ``VLMGenerator`` on ``device``
    (the card unless given) from the checkpoint at its first message."""
    state = {}

    def chat(message: str) -> str:
        if "gen" not in state:
            import torch
            from transformers import AutoTokenizer

            from iadr1_tpu_torch.core.device import resolve_device
            from iadr1_tpu_torch.data.template import get_template
            from iadr1_tpu_torch.eval.generator import (
                GeneratorConfig,
                VLMGenerator,
            )
            from iadr1_tpu_torch.models.params_io import load_safetensors_path
            from iadr1_tpu_torch.models.registry import bundle_from_pretrained

            dev = resolve_device(device)
            bundle = bundle_from_pretrained(model_path)
            params = bundle.convert_hf(load_safetensors_path(model_path),
                                       dtype=torch.bfloat16, device=dev)
            tokenizer = AutoTokenizer.from_pretrained(model_path)
            template = get_template(template_name or bundle.template)
            state["gen"] = VLMGenerator(
                bundle, params, tokenizer, template,
                GeneratorConfig(max_new_tokens=max_new_tokens, batch_size=1),
                device=dev)
        gen = state["gen"]
        return gen.generate(
            [{"messages": [{"role": "user", "content": message}]}])[0]

    return chat


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--chat-model", default=None,
                        help="checkpoint dir for the chat tab")
    parser.add_argument("--chat-template", default=None)
    parser.add_argument("--device", default=None,
                        help="the chat tab's device; default: the CUDA "
                        "card, 'cpu' runs the plain PyTorch path")
    args = parser.parse_args(argv)
    chat_fn = (
        _lazy_chat_fn(args.chat_model, args.chat_template,
                      device=args.device)
        if args.chat_model else None
    )
    create_server(chat_fn=chat_fn, host=args.host, port=args.port).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
