// Kernel A's gstack selection (fused_topk.cu's SEL kGstack): its
// instantiations, compiled apart from the rest of kernel A so that the
// build's compiler processes, one a source, run them at the same time.
// fused_topk.cu holds the code and says what the selection does; this
// unit defines only pmm_fused_topk_gstack_launch, which kernel A's launch
// calls for selection="gstack" / "gpop".
#define PMM_GSTACK_UNIT
#include "fused_topk.cu"
