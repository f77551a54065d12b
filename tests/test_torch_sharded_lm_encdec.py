"""The port's sharded enc-dec family (reduced whisper-base) in 8-rank gloo
worlds on the CPU: the tests of ``tests/test_torch_sharded_lm_scan.py``
(its harness, fixtures and oracles) run on the ``"encdec"`` case.

Whisper-base reduced has 4 heads and 2 kv heads, so (4, 2) shards its
attention by kv heads (grouped), (2, 4) expands the kv heads and (1, 8)
takes the query-row layout, in the encoder, the decoder's self attention
and its cross attention on the gathered encoder states; at 30 decoder
tokens on (1, 8) the decoder stream stays whole and its attention runs
whole on gathered weights while the 16-frame encoder still shards.
``launch.train`` feeds tokens only (as the reference's), so the train
driver's test is not run here; ``launch.serve`` feeds the engine's zero
frames.

By hand (the inputs in ``<dir>`` first, from the scan file's ``_inputs``):

    PYTHONPATH=src python tests/test_torch_sharded_lm_scan.py encdec <dir>
"""

from test_torch_sharded_lm_scan import (  # noqa: F401  (the fixtures and tests, run on NAMES)
    one_rank,
    pytest_generate_tests,
    reference,
    run,
    test_serve_driver_on_a_2x4_mesh_gives_the_single_rank_greedy_tokens,
    test_sharded_logits_match_the_references_unsharded_forward,
    test_sharded_train_step_matches_the_reference,
    test_sharded_train_step_repeats_bitwise,
    test_train_state_restores_from_2x4_onto_4x2,
    test_train_state_restores_from_2x4_onto_one_rank,
)

NAMES = ("encdec",)
