// Where a captured random kernel reads its Philox offset: for a `while`
// whose body draws, under Executor.bind and run_fused (core/graphs.py
// `run_while`, ops/control_flow_ops.py).
//
// Replaces no TPU kernel; host code only. Under a CUDA-graph capture
// PyTorch hands each random kernel a PhiloxCudaState that holds a pointer
// to the generator's one-element device offset (`offset_extragraph_`,
// filled with the generator's offset before each replay) and the offset
// the capture had reached (`offset_intragraph_`); the kernel draws at
// *offset + intragraph. A WHILE node replays its body graph once a trip,
// so every trip would draw at the same offsets. `philox_graph_state` reads
// the pointer and the intragraph offset of one generator while a capture
// is in progress (CUDAGeneratorImpl::philox_cuda_state with an increment
// of 0, which advances nothing): the capture of the loop reads the
// intragraph offset before and after its body, and a one-thread kernel of
// csrc/graph_while.cu adds the difference to the device offset at the end
// of each trip (and subtracts it once after the node).
//
// Built against PyTorch's headers and libraries (native/__init__.py
// passes the include and library paths of the running torch); it is the
// only source that includes them.
#include <ATen/cuda/CUDAGeneratorImpl.h>

#include <mutex>
#include <stdint.h>

extern "C" {

// `pygen` is the address of a torch.Generator (a THPGenerator: the
// CPython object header, 16 bytes, then its at::Generator), which the
// caller checks by the type's basic size. Returns 0; 1 when no capture is
// in progress on the current stream (the state is then not the graph's);
// 2 when PyTorch raised (a generator that is not a CUDA one).
int philox_graph_state(void* pygen, void** offset_out,
                       unsigned long long* intragraph_out) {
  try {
    at::Generator& gen =
        *reinterpret_cast<at::Generator*>(static_cast<char*>(pygen) + 16);
    auto* impl = at::check_generator<at::CUDAGeneratorImpl>(gen);
    std::lock_guard<std::mutex> lock(gen.mutex());
    at::PhiloxCudaState st = impl->philox_cuda_state(0);
    if (!st.captured_) return 1;
    *offset_out = st.offset_.ptr;
    *intragraph_out = st.offset_intragraph_;
    return 0;
  } catch (...) {
    return 2;
  }
}

}  // extern "C"
