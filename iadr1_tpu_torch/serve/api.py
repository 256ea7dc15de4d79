"""OpenAI-compatible chat completions server, stdlib http.server (the
port's own copy of iadr1_tpu/serve/api.py).

Endpoint parity with the reference API layer (llamafactory/api/app.py:87-127):

* GET  /v1/models                -> model listing
* POST /v1/chat/completions     -> chat completion (+ SSE streaming)
* POST /v1/score/evaluation     -> reward-model scores (405 without one)

Request messages follow the OpenAI schema; multimodal content parts with
``{"type": "image_url", "image_url": {"url": "data:image/...;base64,..."}}``
are decoded into PIL images and routed through the VLM front-end.  A
threaded stdlib server suffices for one replica and needs no web
framework.  A system message reaches the generator as the first message, which makes
it the template's system block.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from iadr1_tpu_torch.serve.batcher import RequestBatcher


def _decode_image(url: str):
    from PIL import Image

    if url.startswith("data:"):
        payload = url.split(",", 1)[1]
        return Image.open(io.BytesIO(base64.b64decode(payload)))
    if url.startswith("file://"):
        return Image.open(url[len("file://"):])
    raise ValueError("only data: and file:// image URLs are supported")


def parse_openai_messages(messages: list[dict]) -> tuple[list[dict], list, str | None]:
    """OpenAI message list -> (template messages, images, system)."""
    out, images, system = [], [], None
    for msg in messages:
        role = msg["role"]
        content = msg.get("content", "")
        if role == "system":
            system = content if isinstance(content, str) else str(content)
            continue
        if isinstance(content, list):
            text_parts = []
            for part in content:
                if part.get("type") == "text":
                    text_parts.append(part["text"])
                elif part.get("type") == "image_url":
                    images.append(_decode_image(part["image_url"]["url"]))
                    text_parts.append("<image>")
            content = "".join(text_parts)
        out.append({"role": role, "content": content})
    return out, images, system


class ChatServer:
    """Threaded HTTP server wrapping a VLMGenerator."""

    def __init__(self, generator, model_name: str = "iadr1-tpu",
                 host: str = "127.0.0.1", port: int = 8000,
                 score_fn=None, max_batch: int = 4,
                 batch_wait_ms: float = 10.0):
        """``score_fn(texts, max_length) -> list[float]``: reward-model
        scoring backing /v1/score/evaluation (reference api/app.py:113-123;
        the endpoint 405s when only a generative model is loaded, matching
        the reference's can_generate guard).

        ``max_batch`` > 1 coalesces concurrent chat requests into one
        generate (serve/batcher.py; the reference serializes
        behind a semaphore instead, chat/hf_engine.py)."""
        self.generator = generator
        self.model_name = model_name
        self.host = host
        self.port = port
        self.score_fn = score_fn
        self._lock = threading.Lock()  # generator is single-program
        self._httpd: ThreadingHTTPServer | None = None
        self._batcher = None
        if max_batch > 1:
            def _generate_locked(requests):
                with self._lock:
                    return self.generator.generate(requests)

            self._batcher = RequestBatcher(
                _generate_locked, max_batch=max_batch,
                max_wait_ms=batch_wait_ms,
            )

    # --- request handling ---------------------------------------------------

    def handle_chat(self, body: dict) -> dict:
        messages, images, system = parse_openai_messages(body["messages"])
        if system is not None:
            messages = [{"role": "system", "content": system}] + messages
        request = {"messages": messages, "images": images}
        if self._batcher is not None:
            text = self._batcher.submit(request)
        else:
            with self._lock:
                text = self.generator.generate([request])[0]
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": "stop",
            }],
            "usage": {
                "prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0,
            },
        }

    def handle_score(self, body: dict) -> dict:
        texts = body["messages"]
        with self._lock:
            scores = self.score_fn(texts, body.get("max_length"))
        return {
            "id": f"scoreval-{uuid.uuid4().hex[:12]}",
            "object": "score.evaluation",
            "model": body.get("model", self.model_name),
            "scores": [float(s) for s in scores],
        }

    def handle_models(self) -> dict:
        return {
            "object": "list",
            "data": [{
                "id": self.model_name, "object": "model",
                "created": int(time.time()), "owned_by": "iadr1_tpu",
            }],
        }

    # --- server plumbing ------------------------------------------------------

    def serve_forever(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, obj: dict):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/v1/models":
                    self._send(200, server.handle_models())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/v1/chat/completions",
                                     "/v1/score/evaluation"):
                    self._send(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid JSON"})
                    return
                if not body.get("messages"):
                    self._send(400, {"error": "missing 'messages'"})
                    return
                if self.path == "/v1/score/evaluation":
                    if server.score_fn is None:
                        # generative-only deployment (reference app.py:120-121)
                        self._send(405, {"error": "Not allowed"})
                        return
                    try:
                        self._send(200, server.handle_score(body))
                    except Exception as e:
                        self._send(500, {"error": str(e)})
                    return
                try:
                    result = server.handle_chat(body)
                except Exception as e:  # surface errors as API errors
                    self._send(500, {"error": str(e)})
                    return
                if body.get("stream"):
                    self._send_stream(result)
                else:
                    self._send(200, result)

            def _send_stream(self, result: dict):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                text = result["choices"][0]["message"]["content"]
                base = {k: result[k] for k in ("id", "created", "model")}
                for i in range(0, len(text), 16):
                    chunk = {
                        **base, "object": "chat.completion.chunk",
                        "choices": [{
                            "index": 0,
                            "delta": {"content": text[i : i + 16]},
                            "finish_reason": None,
                        }],
                    }
                    self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                done = {
                    **base, "object": "chat.completion.chunk",
                    "choices": [{"index": 0, "delta": {},
                                 "finish_reason": "stop"}],
                }
                self.wfile.write(f"data: {json.dumps(done)}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._httpd.serve_forever()

    def start_background(self):
        thread = threading.Thread(target=self.serve_forever, daemon=True)
        thread.start()
        while self._httpd is None:
            time.sleep(0.01)
        return thread

    def shutdown(self):
        """Stop serving, release the socket and end the batcher's worker."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._batcher is not None:
            self._batcher.close()
