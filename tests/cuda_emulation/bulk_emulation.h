// CPU emulation of bbx_torch/csrc/bulk.cuh: the bulk copy is a memcpy done
// at once, and each shared-memory barrier -- its arrival count, the bytes
// it still expects and its phase -- lives in a table keyed by its address,
// under one lock; a wait blocks on a condition variable until the phase of
// the given parity has completed.  The protocol (who arrives, who waits on
// which parity) runs as on the card, so a stage read before it landed, or
// refilled before its readers released it, deadlocks or reads stale data
// here too.
#pragma once
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <unordered_map>

struct bbx_mbar_state {
    unsigned count = 0, pending = 0;
    long long tx = 0;
    unsigned phase = 0;
};
inline std::mutex bbx_mbar_mutex;
inline std::condition_variable bbx_mbar_cv;
inline std::unordered_map<const void*, bbx_mbar_state> bbx_mbars;

inline void bbx_mbar_settle(bbx_mbar_state& s) {
    if (s.pending == 0 && s.tx == 0) {
        s.phase ^= 1u;
        s.pending = s.count;
        bbx_mbar_cv.notify_all();
    }
}

inline void bbx_mbar_init(unsigned long long* bar, unsigned count) {
    std::lock_guard<std::mutex> lock(bbx_mbar_mutex);
    bbx_mbars[bar] = {count, count, 0, 0};
}

inline void bbx_mbar_fence_init() {}

inline void bbx_mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
    std::lock_guard<std::mutex> lock(bbx_mbar_mutex);
    bbx_mbar_state& s = bbx_mbars.at(bar);
    s.tx += bytes;
    --s.pending;
    bbx_mbar_settle(s);
}

inline void bbx_mbar_arrive(unsigned long long* bar) {
    std::lock_guard<std::mutex> lock(bbx_mbar_mutex);
    bbx_mbar_state& s = bbx_mbars.at(bar);
    --s.pending;
    bbx_mbar_settle(s);
}

inline void bbx_mbar_wait(unsigned long long* bar, unsigned parity) {
    std::unique_lock<std::mutex> lock(bbx_mbar_mutex);
    bbx_mbar_cv.wait(lock, [&] { return (bbx_mbars.at(bar).phase & 1u) != parity; });
}

inline void bbx_bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
    std::memcpy(dst, src, bytes);
    std::lock_guard<std::mutex> lock(bbx_mbar_mutex);
    bbx_mbar_state& s = bbx_mbars.at(bar);
    s.tx -= bytes;
    bbx_mbar_settle(s);
}
