"""SC-GRPO prompt templates (verbatim recipe data).

These strings are the reference recipe's prompt constants
(train/stage_rl/grpo_ad.py:72-118) -- they are part of the method's data
contract (the reward patterns key off the exact tag grammar they request),
so they are reproduced byte-for-byte (the port's own copy of
iadr1_tpu/train/prompts.py).
"""

# 0-shot (single_img == 1), used as system prompt when use_system_prompt
SYSTEM_PROMPT_0SHOT = (
    'You are an expert in detecting anomalies in image. Your task is to detect if there are any anomalies in the test image.'
    'If you find anomalies in the test image, structure your response with the following format:'
    '<think>[Your process of observation and reasoning is here]</think>'
    '<location>[The location of the anomaly in the image]</location>'
    '<type>[The type of anomaly in the image]</type><answer>[Your final answer is here(yes or no)]</answer>'
    'If no anomalies are detected in the test image, structure your response with the following format:'
    '<think>[Your process of observation and reasoning is here]</think>'
    '<answer>[Your final answer is here(yes or no)]</answer>'
    '{Question}'
)

QUESTION_PROMPT_0SHOT = (
    'You are an expert in detecting defects in image. Your task is to detect if there are any defects in the test image.'
    '{Question}'
)

# 1-shot (single_img == 0): reference image first, test image second
SYSTEM_PROMPT_1SHOT = (
    'You are an expert in detecting anomalies in images. I will provide you with two images: a reference image (first) showing a normal object without defects, and a test image (second) that needs inspection.'
    'Your task is to compare these images and determine if there are any anomalies in the test image. Use the reference image as a baseline for what is considered normal.'
    'If you find anomalies in the test image, structure your response with the following format:'
    '<think>[Your process of observation and reasoning is here]</think>'
    '<location>[The location of the anomaly in the image]</location>'
    '<type>[The type of anomaly in the image]</type><answer>[Your final answer is here(yes or no)]</answer>'
    'If no anomalies are detected in the test image, structure your response with the following format:'
    '<think>[Your process of observation and reasoning is here]</think>'
    '<answer>[Your final answer is here(yes or no)]</answer>'
    'Remember that the first image is always the reference (normal) image, and the second image is the test image that needs inspection.'
    '{Question}'
)

QUESTION_PROMPT_1SHOT = (
    'You are an expert in detecting defects in image. I will provide you with two images: a reference image (first) showing a normal object without defects, and a test image (second) that needs inspection.'
    'Your task is to compare these images and determine if there are any anomalies in the test image. Use the reference image as a baseline for what is considered normal.'
    '{Question}'
)


def make_conversation(example: dict, image_path: str | None = None,
                      use_system_prompt: bool = False,
                      single_img: int = 1) -> dict:
    """RL dataset row -> {"messages": [...], "images": [...], "solution"}.

    Behavior matches grpo_ad.py make_conversation (:135-181): image paths are
    joined under ``image_path``; with use_system_prompt the raw problem is
    the user text under the system prompt, otherwise the question template
    wraps the problem.
    """
    import os

    raw = example.get("image")
    if isinstance(raw, str):
        raw = [raw]
    images = []
    for item in raw or []:
        path = item["path"] if isinstance(item, dict) else item
        images.append(os.path.join(image_path, path) if image_path else path)

    system_prompt = SYSTEM_PROMPT_0SHOT if single_img else SYSTEM_PROMPT_1SHOT
    question_prompt = (
        QUESTION_PROMPT_0SHOT if single_img else QUESTION_PROMPT_1SHOT
    )
    placeholders = "<image>" * len(images)
    if use_system_prompt:
        messages = [
            {"role": "user",
             "content": placeholders + example["problem"]},
        ]
        system = system_prompt
    else:
        messages = [
            {"role": "user",
             "content": placeholders
             + question_prompt.format(Question=example["problem"])},
        ]
        system = None
    return {
        "messages": messages,
        "system": system,
        "images": images,
        "solution": example.get("solution"),
    }
