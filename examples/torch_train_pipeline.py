"""End-to-end training of the PyTorch port through the pod pipeline: a
~100M-param qwen3-family model on 2 GPipe stages with ParetoPipe-chosen
cuts, checkpointed, resuming where it stopped (the twin of
``examples/train_pipeline.py``).

    PYTHONPATH=src python examples/torch_train_pipeline.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_pipeline.py --device cpu \\
        --steps 20

Stage k runs on ``cuda:{k % cards}`` (both on the one card of a
one-card machine), or on the CPU with ``--device cpu``.
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    defaults = ["--arch", "qwen3-1.7b", "--reduced",
                "--d-model", "512", "--n-layers", "8",
                "--steps", "300", "--batch", "4", "--seq", "256",
                "--pods", "2", "--microbatches", "2", "--auto-partition",
                "--ckpt-dir", "runs/torch_train_pipeline", "--ckpt-every",
                "100"]
    main(defaults + argv)
