"""Web UI ("LlamaBoard" counterpart): training form, run monitor, chat
(the port's own copy of iadr1_tpu/webui/).

The reference ships a ~5.5k-LoC Gradio app (llamafactory/webui/: interface,
runner, chatter, components).  This TPU build keeps the same three
capabilities -- configure-and-launch a training run of the port's CLIs as
a subprocess (on the card unless the form says ``device``), stream its
trainer_log.jsonl progress, and chat with a checkpoint -- on the Python
standard library (http.server + a single-page HTML app), so the framework
has no Gradio dependency.
"""

from iadr1_tpu_torch.webui.runner import Runner
from iadr1_tpu_torch.webui.app import create_server, main
