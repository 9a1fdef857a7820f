// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), and their stand-ins for the host emulation that the CPU
// tests compile with -DDF_HOST_EMULATION: there a copy is a plain copy, done
// when it is issued.
//
// A thread issues copies, then waits for all of ITS copies
// (df_cp_async_wait_all), or commits them as a group and later waits until
// at most N of its groups are in flight (df_cp_async_commit,
// df_cp_async_wait_group<N>); the barrier after a wait makes every thread's
// copies visible to the block. The including file defines DF_FN first.

#pragma once

#ifndef DF_HOST_EMULATION
// 4 bytes; `valid` false fills the destination with zero and reads nothing
// (src must still be a device address)
DF_FN void df_cp_async4(float* dst, const float* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes; both addresses 16-byte aligned
DF_FN void df_cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}

DF_FN void df_cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// close the thread's group of copies issued since the last commit
DF_FN void df_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's committed groups are in flight
template <int N>
DF_FN void df_cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#else
DF_FN void df_cp_async4(float* dst, const float* src, bool valid) {
    *dst = valid ? *src : 0.f;
}

DF_FN void df_cp_async16(float* dst, const float* src) {
    for (int i = 0; i < 4; ++i) dst[i] = src[i];
}

DF_FN void df_cp_async_wait_all() {}

DF_FN void df_cp_async_commit() {}

template <int N>
DF_FN void df_cp_async_wait_group() {}
#endif

// n floats from src to dst (dst 16-byte aligned), by the threads of a block:
// 16-byte copies where src is aligned too, else 4-byte ones
DF_FN void df_cp_async_floats(float* dst, const float* src, int n, int tid,
                              int nt) {
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        head = n / 4 * 4;
        for (int i = 4 * tid; i < head; i += 4 * nt)
            df_cp_async16(dst + i, src + i);
    }
    for (int i = head + tid; i < n; i += nt)
        df_cp_async4(dst + i, src + i, true);
}
