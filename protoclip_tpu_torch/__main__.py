"""``python -m protoclip_tpu_torch`` — the port's experiment runner
(``cli/main.py``), the counterpart of ``python -m protoclip_tpu`` and of the
reference's ``python main.py`` (ref ``main.py:475``).  The port's other
entries: ``-m protoclip_tpu_torch.cli.{extract,export,serve,ood,tsne,transcribe,ros_node}``
and the block-variant bench ``-m protoclip_tpu_torch.scripts.bench_block_variants``."""

from protoclip_tpu_torch.cli.main import main

if __name__ == "__main__":
    main()
