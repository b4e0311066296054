// Native trajectory-dataset loader for bild_tpu_torch (a copy of
// bild_tpu's; it depends on no framework).
//
// Role: host-side input for dataset-scale runs: parsing 10k+ trajectory
// CSV tables fast enough to keep the GPU fed.
//
// Format: delimited text (',', '\t' or ' '); optional header line. Columns:
//   traj_id, frame, v0, v1, ..., v{d-1}
// Rows may appear in any order; rows of one trajectory are sorted by frame;
// gaps in the frame index become missing frames downstream (python side).
//
// Exposed C ABI (consumed via ctypes, bild_tpu_torch/io.py):
//   bild_csv_load(path, &handle) -> status
//   bild_csv_dims(handle, &n_trajs, &total_rows, &n_values)
//   bild_csv_fill(handle, ids, offsets, frames, data)
//   bild_csv_free(handle)
//
// Parsing is parallelized by splitting the file at line boundaries across
// hardware threads; per-thread partial groups are merged, then each
// trajectory's rows are sorted by frame.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Row {
    int64_t frame;
    std::vector<double> vals;
};

struct Dataset {
    std::vector<int64_t> ids;                   // per trajectory
    std::vector<std::vector<Row>> rows;         // per trajectory, frame-sorted
    int n_values = 0;                           // d columns
    int64_t total_rows = 0;
};

using Groups = std::unordered_map<int64_t, std::vector<Row>>;

bool parse_chunk(const char* begin, const char* end, int* n_values, Groups* out) {
    const char* p = begin;
    while (p < end) {
        const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;

        // skip blank / comment lines
        if (line_end > p && *p != '#') {
            char* cursor = const_cast<char*>(p);
            errno = 0;
            char* next = nullptr;
            auto skip_delims = [&cursor, line_end]() {
                while (cursor < line_end &&
                       (*cursor == ',' || *cursor == '\t' || *cursor == ' ' ||
                        *cursor == '\r' || *cursor == ';'))
                    ++cursor;
            };
            double id_d = strtod(cursor, &next);
            if (next == cursor) {  // non-numeric (header) line: skip
                p = line_end + 1;
                continue;
            }
            cursor = next;
            skip_delims();
            double frame_d = strtod(cursor, &next);
            if (next == cursor) { p = line_end + 1; continue; }
            cursor = next;

            Row row;
            row.frame = static_cast<int64_t>(frame_d);
            while (cursor < line_end) {
                while (cursor < line_end &&
                       (*cursor == ',' || *cursor == '\t' || *cursor == ' ' ||
                        *cursor == '\r' || *cursor == ';'))
                    ++cursor;
                if (cursor >= line_end) break;
                double v = strtod(cursor, &next);
                if (next == cursor) {
                    // unparseable token (e.g. "nan" handled by strtod; other
                    // garbage): treat as missing value
                    v = std::strtod("nan", nullptr);
                    while (cursor < line_end && *cursor != ',' && *cursor != '\t'
                           && *cursor != ' ' && *cursor != ';')
                        ++cursor;
                    next = const_cast<char*>(cursor);
                }
                row.vals.push_back(v);
                cursor = next;
            }
            if (!row.vals.empty()) {
                // track the MAX row width: a short first row must not
                // silently truncate later rows' columns
                if (static_cast<int>(row.vals.size()) > *n_values)
                    *n_values = static_cast<int>(row.vals.size());
                (*out)[static_cast<int64_t>(id_d)].push_back(std::move(row));
            }
        }
        p = line_end + 1;
    }
    return true;
}

}  // namespace

extern "C" {

// returns 0 on success; handle written through *out_handle.
// The whole body is exception-guarded: a C++ exception crossing the C ABI
// into ctypes is undefined behavior and in practice std::terminate()s the
// host Python process — any failure must surface as a status code instead.
static int bild_csv_load_impl(const char* path, void** out_handle) {
    std::ifstream f(path, std::ios::binary | std::ios::ate);
    if (!f) return 1;
    const std::streamsize size = f.tellg();
    f.seekg(0);
    std::string buf(static_cast<size_t>(size), '\0');
    if (!f.read(buf.data(), size)) return 2;

    unsigned n_threads = std::max(1u, std::thread::hardware_concurrency());
    n_threads = std::min<unsigned>(n_threads, 16);
    if (size < (1 << 20)) n_threads = 1;  // small files: skip thread overhead

    // chunk boundaries at newlines
    std::vector<const char*> bounds;
    bounds.push_back(buf.data());
    for (unsigned i = 1; i < n_threads; ++i) {
        const char* guess = buf.data() + size * i / n_threads;
        const char* nl = static_cast<const char*>(
            memchr(guess, '\n', buf.data() + size - guess));
        bounds.push_back(nl ? nl + 1 : buf.data() + size);
    }
    bounds.push_back(buf.data() + size);

    std::vector<Groups> partials(n_threads);
    std::vector<int> n_vals(n_threads, 0);
    {
        std::vector<std::thread> threads;
        for (unsigned i = 0; i < n_threads; ++i) {
            threads.emplace_back(parse_chunk, bounds[i], bounds[i + 1],
                                 &n_vals[i], &partials[i]);
        }
        for (auto& t : threads) t.join();
    }

    auto* ds = new Dataset();
    for (unsigned i = 0; i < n_threads; ++i)
        ds->n_values = std::max(ds->n_values, n_vals[i]);

    // merge partial groups
    Groups merged;
    for (auto& part : partials) {
        for (auto& kv : part) {
            auto& dst = merged[kv.first];
            if (dst.empty()) dst = std::move(kv.second);
            else dst.insert(dst.end(),
                            std::make_move_iterator(kv.second.begin()),
                            std::make_move_iterator(kv.second.end()));
        }
    }

    // deterministic trajectory order: ascending id
    std::vector<int64_t> ids;
    ids.reserve(merged.size());
    for (auto& kv : merged) ids.push_back(kv.first);
    std::sort(ids.begin(), ids.end());

    for (int64_t id : ids) {
        auto& rows = merged[id];
        std::stable_sort(rows.begin(), rows.end(),
                         [](const Row& a, const Row& b) { return a.frame < b.frame; });
        ds->total_rows += static_cast<int64_t>(rows.size());
        ds->ids.push_back(id);
        ds->rows.push_back(std::move(rows));
    }

    *out_handle = ds;
    return 0;
}

int bild_csv_load(const char* path, void** out_handle) {
    try {
        return bild_csv_load_impl(path, out_handle);
    } catch (...) {
        return 3;  // any C++ exception (bad_alloc, system_error from
                   // std::thread, ...) -> clean status, python raises IOError
    }
}

void bild_csv_dims(void* handle, int64_t* n_trajs, int64_t* total_rows,
                   int* n_values) {
    auto* ds = static_cast<Dataset*>(handle);
    *n_trajs = static_cast<int64_t>(ds->ids.size());
    *total_rows = ds->total_rows;
    *n_values = ds->n_values;
}

// ids: (n_trajs,), offsets: (n_trajs+1,), frames: (total_rows,),
// data: (total_rows * n_values,) row-major
void bild_csv_fill(void* handle, int64_t* ids, int64_t* offsets,
                   int64_t* frames, double* data) {
    auto* ds = static_cast<Dataset*>(handle);
    const int d = ds->n_values;
    int64_t pos = 0;
    offsets[0] = 0;
    for (size_t i = 0; i < ds->ids.size(); ++i) {
        ids[i] = ds->ids[i];
        for (const Row& row : ds->rows[i]) {
            frames[pos] = row.frame;
            for (int j = 0; j < d; ++j)
                data[pos * d + j] = j < static_cast<int>(row.vals.size())
                                        ? row.vals[j]
                                        : std::strtod("nan", nullptr);
            ++pos;
        }
        offsets[i + 1] = pos;
    }
}

void bild_csv_free(void* handle) { delete static_cast<Dataset*>(handle); }

}  // extern "C"
