"""memory_codec_ms: device ms a round of the aggregate's gradient-memory
codec, the program's own ``ranl.memory_decode`` and
``ranl.memory_encode`` spans together (CUDA events, a span a leaf;
``optim.ranl_llm``): on one card the bf16 memory's decode to f32 and the
new memory's encode, 12·N·P bytes a round at N workers and P
parameters; on a mesh the encode of each trained leaf, and a decode only
where a leaf is uncovered.  From the program's tracer pass
(``harness/program_trace``); none where the program opens neither
span."""

from harness.program_trace import span_ms


def read(run):
    return span_ms(run, "ranl.memory_decode", "ranl.memory_encode")
