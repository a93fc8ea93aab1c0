// Native track store: the host-side observation bookkeeping of the
// incremental mapper (point pool + per-point tracks + per-image keypoint
// assignments), a copy of mpsfm_tpu/native/trackstore.cpp. It replaces the
// corresponding COLMAP C++ containers (Reconstruction/ObservationManager):
// the device programs do the math; this keeps the sequential
// pointer-chasing bookkeeping out of Python dict/list overhead.
//
// Exposed as a C API for ctypes. Built at first use by
// mpsfm_tpu_torch/native/__init__.py (g++ -O2 -shared -fPIC) into
// mpsfm_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Obs {
    int32_t imid;
    int32_t kp;
};

struct TrackStore {
    // per-image keypoint -> point id (-1 none)
    std::vector<std::vector<int64_t>> point3D_ids;
    // point pool
    std::vector<double> xyz;            // 3 * capacity
    std::vector<uint8_t> alive;
    std::vector<int32_t> track_len;
    std::vector<std::vector<Obs>> tracks;
    std::vector<int64_t> free_list;
    int64_t num_slots = 0;
};

}  // namespace

extern "C" {

void* ts_create() { return new TrackStore(); }

void ts_destroy(void* h) { delete static_cast<TrackStore*>(h); }

void ts_add_image(void* h, int64_t imid, int64_t num_kps) {
    auto* ts = static_cast<TrackStore*>(h);
    if ((int64_t)ts->point3D_ids.size() <= imid) ts->point3D_ids.resize(imid + 1);
    ts->point3D_ids[imid].assign(num_kps, -1);
}

int64_t ts_num_points(void* h) {
    auto* ts = static_cast<TrackStore*>(h);
    int64_t n = 0;
    for (auto a : ts->alive) n += a;
    return n;
}

int64_t ts_num_slots(void* h) { return static_cast<TrackStore*>(h)->num_slots; }

// track: pairs (imid, kp) flattened. Returns pid or -1.
int64_t ts_add_point(void* h, const double* xyz, const int64_t* track, int64_t n_obs) {
    auto* ts = static_cast<TrackStore*>(h);
    int64_t pid;
    if (!ts->free_list.empty()) {
        pid = ts->free_list.back();
        ts->free_list.pop_back();
    } else {
        pid = ts->num_slots++;
        ts->xyz.resize(3 * ts->num_slots);
        ts->alive.resize(ts->num_slots);
        ts->track_len.resize(ts->num_slots);
        ts->tracks.resize(ts->num_slots);
    }
    std::memcpy(&ts->xyz[3 * pid], xyz, 3 * sizeof(double));
    ts->alive[pid] = 1;
    ts->tracks[pid].clear();
    for (int64_t i = 0; i < n_obs; ++i) {
        int64_t imid = track[2 * i];
        int64_t kp = track[2 * i + 1];
        if (ts->point3D_ids[imid][kp] >= 0) continue;
        ts->tracks[pid].push_back({(int32_t)imid, (int32_t)kp});
        ts->point3D_ids[imid][kp] = pid;
    }
    ts->track_len[pid] = (int32_t)ts->tracks[pid].size();
    if (ts->track_len[pid] == 0) {
        ts->alive[pid] = 0;
        ts->free_list.push_back(pid);
        return -1;
    }
    return pid;
}

void ts_delete_point(void* h, int64_t pid) {
    auto* ts = static_cast<TrackStore*>(h);
    for (const auto& o : ts->tracks[pid]) ts->point3D_ids[o.imid][o.kp] = -1;
    ts->tracks[pid].clear();
    ts->track_len[pid] = 0;
    ts->alive[pid] = 0;
    ts->free_list.push_back(pid);
}

int32_t ts_add_observation(void* h, int64_t pid, int64_t imid, int64_t kp) {
    auto* ts = static_cast<TrackStore*>(h);
    if (ts->point3D_ids[imid][kp] >= 0) return 0;
    ts->tracks[pid].push_back({(int32_t)imid, (int32_t)kp});
    ts->track_len[pid]++;
    ts->point3D_ids[imid][kp] = pid;
    return 1;
}

// Returns 1 if the point was auto-deleted (track fell below 2).
int32_t ts_remove_observation(void* h, int64_t pid, int64_t imid, int64_t kp) {
    auto* ts = static_cast<TrackStore*>(h);
    auto& tr = ts->tracks[pid];
    for (size_t i = 0; i < tr.size(); ++i) {
        if (tr[i].imid == imid && tr[i].kp == kp) {
            tr.erase(tr.begin() + i);
            break;
        }
    }
    ts->track_len[pid]--;
    ts->point3D_ids[imid][kp] = -1;
    if (ts->track_len[pid] < 2) {
        ts_delete_point(h, pid);
        return 1;
    }
    return 0;
}

int64_t ts_track_len(void* h, int64_t pid) { return static_cast<TrackStore*>(h)->track_len[pid]; }

int32_t ts_alive(void* h, int64_t pid) { return static_cast<TrackStore*>(h)->alive[pid]; }

void ts_get_xyz(void* h, int64_t pid, double* out) {
    auto* ts = static_cast<TrackStore*>(h);
    std::memcpy(out, &ts->xyz[3 * pid], 3 * sizeof(double));
}

void ts_set_xyz(void* h, int64_t pid, const double* v) {
    auto* ts = static_cast<TrackStore*>(h);
    std::memcpy(&ts->xyz[3 * pid], v, 3 * sizeof(double));
}

// Bulk copies for device-program staging.
void ts_copy_xyz_bulk(void* h, const int64_t* pids, int64_t n, double* out) {
    auto* ts = static_cast<TrackStore*>(h);
    for (int64_t i = 0; i < n; ++i) std::memcpy(out + 3 * i, &ts->xyz[3 * pids[i]], 3 * sizeof(double));
}

void ts_set_xyz_bulk(void* h, const int64_t* pids, int64_t n, const double* vals) {
    auto* ts = static_cast<TrackStore*>(h);
    for (int64_t i = 0; i < n; ++i) std::memcpy(&ts->xyz[3 * pids[i]], vals + 3 * i, 3 * sizeof(double));
}

int64_t ts_get_track(void* h, int64_t pid, int64_t* out, int64_t max_n) {
    auto* ts = static_cast<TrackStore*>(h);
    const auto& tr = ts->tracks[pid];
    int64_t n = (int64_t)tr.size();
    if (n > max_n) n = max_n;
    for (int64_t i = 0; i < n; ++i) {
        out[2 * i] = tr[i].imid;
        out[2 * i + 1] = tr[i].kp;
    }
    return (int64_t)tr.size();
}

int64_t ts_alive_pids(void* h, int64_t* out, int64_t max_n) {
    auto* ts = static_cast<TrackStore*>(h);
    int64_t n = 0;
    for (int64_t p = 0; p < ts->num_slots && n < max_n; ++p)
        if (ts->alive[p]) out[n++] = p;
    return n;
}

// Flat observation table for all (or selected) points: returns count.
int64_t ts_observations(void* h, const int64_t* pids, int64_t n_pids, int64_t* out_pid,
                        int64_t* out_im, int64_t* out_kp, int64_t max_n) {
    auto* ts = static_cast<TrackStore*>(h);
    int64_t n = 0;
    for (int64_t i = 0; i < n_pids; ++i) {
        int64_t pid = pids[i];
        if (!ts->alive[pid]) continue;
        for (const auto& o : ts->tracks[pid]) {
            if (n >= max_n) return n;
            out_pid[n] = pid;
            out_im[n] = o.imid;
            out_kp[n] = o.kp;
            ++n;
        }
    }
    return n;
}

void ts_image_point_ids(void* h, int64_t imid, int64_t* out, int64_t n_kps) {
    auto* ts = static_cast<TrackStore*>(h);
    const auto& v = ts->point3D_ids[imid];
    int64_t n = (int64_t)v.size();
    if (n > n_kps) n = n_kps;
    std::memcpy(out, v.data(), n * sizeof(int64_t));
}

void ts_track_lens(void* h, const int64_t* pids, int64_t n, int32_t* out) {
    auto* ts = static_cast<TrackStore*>(h);
    for (int64_t i = 0; i < n; ++i) out[i] = ts->track_len[pids[i]];
}

}  // extern "C"
