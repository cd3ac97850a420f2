"""ScienceQA -> LLaVA-format dataset conversion.

Rebuild of the reference's SQA prep (reference:
scripts/convert_sqa_to_llava.py + the chatbot subset of
convert_sqa_to_llava_base_prompt.py): builds the QCM-LEA-family prompts
byte-identically and emits either the conversations-json training format
or the instruction/output jsonl.

Usage:
  python -m modelcompose_tpu_torch.data.convert_sqa convert_to_llava \
      --base-dir SQA_DIR --split train [--prompt-format QCM-LEA]
  python -m modelcompose_tpu_torch.data.convert_sqa convert_to_jsonl \
      --base-dir SQA_DIR --split val [--prompt-format QCM-LEPA]

The port's copy of ``modelcompose_tpu/data/convert_sqa.py``.
"""

from __future__ import annotations

import argparse
import json
import os

OPTIONS = ["A", "B", "C", "D", "E"]


def get_context_text(problem, use_caption: bool) -> str:
    txt_context = problem["hint"]
    img_context = problem["caption"] if use_caption else ""
    context = " ".join([txt_context, img_context]).strip()
    return context if context else "N/A"


def get_choice_text(problem, options) -> str:
    return " ".join(f"({options[i]}) {c}"
                    for i, c in enumerate(problem["choices"]))


def create_one_example_chatbot(fmt, question, context, choice, answer,
                               lecture, solution,
                               test_example: bool = True):
    """reference: convert_sqa_to_llava_base_prompt.py:41-104 — the format
    strings ARE the protocol and must match byte-for-byte."""
    input_format, output_format = fmt.split("-")

    inputs = {
        "CQM": f"Context: {context}\nQuestion: {question}\n"
               f"Options: {choice}\n",
        "QCM": f"Question: {question}\nContext: {context}\n"
               f"Options: {choice}\n",
        "QCML": f"Question: {question}\nContext: {context}\n"
                f"Options: {choice}\nBECAUSE: {lecture}\n",
        "QCME": f"Question: {question}\nContext: {context}\n"
                f"Options: {choice}\nBECAUSE: {solution}\n",
        "QCMLE": f"Question: {question}\nContext: {context}\n"
                 f"Options: {choice}\nBECAUSE: {lecture} {solution}\n",
        "QCLM": f"Question: {question}\nContext: {context}\n"
                f"BECAUSE: {lecture}\nOptions: {choice}\n",
        "QCEM": f"Question: {question}\nContext: {context}\n"
                f"BECAUSE: {solution}\nOptions: {choice}\n",
        "QCLEM": f"Question: {question}\nContext: {context}\n"
                 f"BECAUSE: {lecture} {solution}\nOptions: {choice}\n",
    }
    text_in = inputs[input_format]

    if test_example:
        text_out = "Answer:"
    else:
        outputs = {
            "A": f"Answer: The answer is {answer}.",
            "AL": f"Answer: The answer is {answer}. BECAUSE: {solution}",
            "AE": f"Answer: The answer is {answer}. BECAUSE: {lecture}",
            "ALE": f"Answer: The answer is {answer}. "
                   f"BECAUSE: {lecture} {solution}",
            "AEL": f"Answer: The answer is {answer}. "
                   f"BECAUSE: {solution} {lecture}",
            "LA": f"Answer: {lecture} The answer is {answer}.",
            "EA": f"Answer: {solution} The answer is {answer}.",
            "LEA": f"Answer: {lecture} {solution} "
                   f"The answer is {answer}.",
            "ELA": f"Answer: {solution} {lecture} "
                   f"The answer is {answer}.",
        }
        if output_format == "LEPA":
            text_out = ""
            if lecture.strip():
                text_out += f"LECTURE: {lecture}\n"
            if solution.strip():
                text_out += f"SOLUTION: {solution}\n"
            text_out += "###\n"
            text_out += f"ANSWER: {answer}."
        else:
            text_out = outputs[output_format]

    text_in = text_in.replace("  ", " ").strip()
    text_out = text_out.replace("  ", " ").strip()
    if text_in.endswith("BECAUSE:"):
        text_in = text_in.replace("BECAUSE:", "").strip()
    if text_out.endswith("BECAUSE:"):
        text_out = text_out.replace("BECAUSE:", "").strip()
    return text_in, text_out


def build_prompt_chatbot(problems, shot_qids, prompt_format,
                         use_caption=False, options=OPTIONS,
                         is_test=False):
    """reference: convert_sqa_to_llava_base_prompt.py:221-242."""
    examples = {}
    for qid in shot_qids:
        p = problems[qid]
        examples[qid] = create_one_example_chatbot(
            prompt_format,
            question=p["question"],
            context=get_context_text(p, use_caption),
            choice=get_choice_text(p, options),
            answer=options[p["answer"]],
            lecture=p["lecture"].replace("\n", "\\n").replace("\\n", "\n"),
            solution=p["solution"].replace("\n", "\\n").replace("\\n",
                                                                "\n"),
            test_example=is_test)
    return examples


def _load_split(base_dir, split):
    split_indices = json.load(
        open(os.path.join(base_dir, "pid_splits.json")))[split]
    problems = json.load(open(os.path.join(base_dir, "problems.json")))
    return split_indices, problems


def _strip(text_in, text_out):
    if text_in.startswith("Question: "):
        text_in = text_in.replace("Question: ", "")
    if text_out.startswith("Answer: "):
        text_out = text_out.replace("Answer: ", "")
    return text_in, text_out


def convert_to_llava(base_dir, split, prompt_format="QCM-LEA"):
    """reference: convert_sqa_to_llava.py:8-46."""
    split_indices, problems = _load_split(base_dir, split)
    split_problems = build_prompt_chatbot(problems, split_indices,
                                          prompt_format, is_test=False)
    target = []
    for prob_id, (text_in, text_out) in split_problems.items():
        text_in, text_out = _strip(text_in, text_out)
        rec = {"id": prob_id,
               "conversations": [
                   {"from": "human", "value": text_in},
                   {"from": "gpt", "value": text_out}]}
        if problems[prob_id]["image"] is not None:
            rec["image"] = os.path.join(prob_id,
                                        problems[prob_id]["image"])
            rec["conversations"][0]["value"] = f"{text_in}\n<image>"
        target.append(rec)
    out = os.path.join(base_dir, f"llava_{split}_{prompt_format}.json")
    with open(out, "w") as f:
        json.dump(target, f, indent=2)
    return target


def convert_to_jsonl(base_dir, split, prompt_format="QCM-LEPA"):
    """reference: convert_sqa_to_llava.py:49-81."""
    split_indices, problems = _load_split(base_dir, split)
    split_problems = build_prompt_chatbot(problems, split_indices,
                                          prompt_format, is_test=False)
    out = os.path.join(base_dir, f"scienceqa_{split}_{prompt_format}.jsonl")
    rows = []
    with open(out, "w") as f:
        for prob_id, (text_in, text_out) in split_problems.items():
            text_in, text_out = _strip(text_in, text_out)
            rec = {"id": prob_id, "instruction": text_in,
                   "output": text_out}
            if problems[prob_id]["image"] is not None:
                rec = {"id": prob_id,
                       "image": os.path.join(prob_id,
                                             problems[prob_id]["image"]),
                       "instruction": f"{text_in}\n<image>",
                       "output": text_out}
            rows.append(rec)
            f.write(json.dumps(rec) + "\n")
    return rows


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("task", choices=["convert_to_llava",
                                         "convert_to_jsonl"])
    parser.add_argument("--base-dir", required=True)
    parser.add_argument("--split", required=True)
    parser.add_argument("--prompt-format", default=None)
    args = parser.parse_args()
    fn = globals()[args.task]
    kwargs = {"base_dir": args.base_dir, "split": args.split}
    if args.prompt_format:
        kwargs["prompt_format"] = args.prompt_format
    recs = fn(**kwargs)
    print(f"Number of samples: {len(recs)}")


if __name__ == "__main__":
    main()
