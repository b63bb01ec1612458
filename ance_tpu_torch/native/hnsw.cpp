// From-scratch HNSW (Hierarchical Navigable Small World) ANN index, L2
// metric, C ABI for ctypes.
//
// The torch port's copy of native/hnsw.cpp: the same graph, seeding and
// C surface, with a distance whose summation order is written out rather
// than left to a reassociation licence; built by
// ance_tpu_torch/utils/native_build.py.
//
// Native replacement for the FAISS IndexHNSWFlat capability the reference
// wraps in DenseHNSWFlatIndexer (reference utils/dpr_utils.py:164-228;
// SURVEY.md §2.3). Inner-product search is obtained by the caller through
// the standard IP→L2 aux-dimension transform.
//
// Algorithm: Malkov & Yashunin, "Efficient and robust approximate nearest
// neighbor search using HNSW graphs" (TPAMI 2018).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Hnsw {
    int dim;
    int M;               // links per node on upper layers
    int M0;              // links at layer 0 (2*M)
    int ef_construction;
    int ef_search = 128;
    double level_mult;
    std::mt19937 rng;

    std::vector<float> vecs;               // n * dim
    std::vector<int> levels;                // per node
    // links[layer][node] = neighbor ids; flattened per node with capacity
    std::vector<std::vector<std::vector<int>>> links;  // [layer][node][..]
    int entry = -1;
    int max_level = -1;

    int size() const { return (int)levels.size(); }

    // Squared L2 in LANES independent partial sums, lane j taking the
    // elements i with i % LANES == j, then added pairwise in a fixed order.
    // A single `s += d*d` chain is one serial dependency that -O3 may not
    // vectorise without a licence to reassociate, and such a licence also
    // leaves NaN and Inf comparisons unspecified. Here the order of every
    // addition is written down, so -O3 vectorises the lanes as they stand
    // and the result is one IEEE-defined function of the inputs.
    static constexpr int LANES = 16;
    float dist(const float* a, const float* b) const {
        float s[LANES] = {};
        int i = 0;
        for (; i + LANES <= dim; i += LANES)
            for (int j = 0; j < LANES; ++j) {
                float d = a[i + j] - b[i + j];
                s[j] += d * d;
            }
        for (int j = 0; i < dim; ++i, ++j) {
            float d = a[i] - b[i];
            s[j] += d * d;
        }
        for (int w = LANES / 2; w > 0; w /= 2)
            for (int j = 0; j < w; ++j) s[j] += s[j + w];
        return s[0];
    }

    const float* vec(int id) const { return vecs.data() + (size_t)id * dim; }

    int random_level() {
        std::uniform_real_distribution<double> u(0.0, 1.0);
        double r = u(rng);
        int lvl = (int)(-std::log(std::max(r, 1e-12)) * level_mult);
        return lvl;
    }

    // Greedy descent: single nearest neighbor walk on a layer.
    int greedy(const float* q, int start, int layer) const {
        int cur = start;
        float cur_d = dist(q, vec(cur));
        bool improved = true;
        while (improved) {
            improved = false;
            for (int nb : links[layer][cur]) {
                float d = dist(q, vec(nb));
                if (d < cur_d) {
                    cur_d = d;
                    cur = nb;
                    improved = true;
                }
            }
        }
        return cur;
    }

    // ef-search on one layer: returns up to ef (dist, id) pairs, sorted asc.
    std::vector<std::pair<float, int>> search_layer(
            const float* q, int start, int ef, int layer,
            std::vector<uint8_t>& visited, std::vector<int>& touched) const {
        // candidates: min-heap by distance (use negated in max-heap)
        std::priority_queue<std::pair<float, int>,
                            std::vector<std::pair<float, int>>,
                            std::greater<>> cand;
        std::priority_queue<std::pair<float, int>> best;  // max-heap

        float d0 = dist(q, vec(start));
        cand.emplace(d0, start);
        best.emplace(d0, start);
        visited[start] = 1;
        touched.push_back(start);

        while (!cand.empty()) {
            auto [d, c] = cand.top();
            if (d > best.top().first && (int)best.size() >= ef) break;
            cand.pop();
            for (int nb : links[layer][c]) {
                if (visited[nb]) continue;
                visited[nb] = 1;
                touched.push_back(nb);
                float dn = dist(q, vec(nb));
                if ((int)best.size() < ef || dn < best.top().first) {
                    cand.emplace(dn, nb);
                    best.emplace(dn, nb);
                    if ((int)best.size() > ef) best.pop();
                }
            }
        }
        std::vector<std::pair<float, int>> out(best.size());
        for (int i = (int)best.size() - 1; i >= 0; --i) {
            out[i] = best.top();
            best.pop();
        }
        return out;
    }

    // Heuristic neighbor selection (keep closest, diversity pruning).
    std::vector<int> select_neighbors(
            const std::vector<std::pair<float, int>>& cands, int m) const {
        std::vector<int> out;
        for (const auto& [d, id] : cands) {   // cands sorted ascending
            bool ok = true;
            for (int sel : out) {
                if (dist(vec(id), vec(sel)) < d) { ok = false; break; }
            }
            if (ok) out.push_back(id);
            if ((int)out.size() >= m) break;
        }
        // backfill with closest skipped if underfull
        if ((int)out.size() < m) {
            for (const auto& [d, id] : cands) {
                if ((int)out.size() >= m) break;
                if (std::find(out.begin(), out.end(), id) == out.end())
                    out.push_back(id);
            }
        }
        return out;
    }

    void add_one(const float* v) {
        int id = size();
        vecs.insert(vecs.end(), v, v + dim);
        int lvl = random_level();
        levels.push_back(lvl);
        while ((int)links.size() <= lvl) links.emplace_back();
        for (auto& layer : links) layer.resize(id + 1);

        if (entry < 0) {
            entry = id;
            max_level = lvl;
            return;
        }

        std::vector<uint8_t> visited(size(), 0);
        std::vector<int> touched;
        int cur = entry;
        for (int layer = max_level; layer > lvl; --layer)
            cur = greedy(v, cur, layer);

        for (int layer = std::min(lvl, max_level); layer >= 0; --layer) {
            for (int t : touched) visited[t] = 0;
            touched.clear();
            auto near = search_layer(v, cur, ef_construction, layer, visited,
                                     touched);
            int m = layer == 0 ? M0 : M;
            auto selected = select_neighbors(near, M);
            links[layer][id] = selected;
            for (int nb : selected) {
                auto& nblinks = links[layer][nb];
                nblinks.push_back(id);
                if ((int)nblinks.size() > m) {
                    // prune: keep m closest to nb
                    std::vector<std::pair<float, int>> scored;
                    scored.reserve(nblinks.size());
                    for (int x : nblinks)
                        scored.emplace_back(dist(vec(nb), vec(x)), x);
                    std::sort(scored.begin(), scored.end());
                    nblinks = select_neighbors(scored, m);
                }
            }
            if (!near.empty()) cur = near.front().second;
        }
        if (lvl > max_level) {
            max_level = lvl;
            entry = id;
        }
    }

    void search(const float* q, int k, int64_t* out_ids,
                float* out_dists) const {
        if (entry < 0) {
            for (int i = 0; i < k; ++i) { out_ids[i] = -1; out_dists[i] = 0; }
            return;
        }
        int cur = entry;
        for (int layer = max_level; layer > 0; --layer)
            cur = greedy(q, cur, layer);
        std::vector<uint8_t> visited(size(), 0);
        std::vector<int> touched;
        auto near = search_layer(q, cur, std::max(ef_search, k), 0, visited,
                                 touched);
        int n = std::min<int>(k, (int)near.size());
        for (int i = 0; i < n; ++i) {
            out_ids[i] = near[i].second;
            out_dists[i] = near[i].first;
        }
        for (int i = n; i < k; ++i) { out_ids[i] = -1; out_dists[i] = 0.f; }
    }
};

}  // namespace

extern "C" {

void* hnsw_create(int dim, int M, int ef_construction, unsigned seed) {
    auto* h = new Hnsw();
    h->dim = dim;
    h->M = M;
    h->M0 = 2 * M;
    h->ef_construction = ef_construction;
    h->level_mult = 1.0 / std::log((double)M);
    h->rng.seed(seed);
    return h;
}

void hnsw_free(void* handle) { delete static_cast<Hnsw*>(handle); }

void hnsw_set_ef(void* handle, int ef) {
    static_cast<Hnsw*>(handle)->ef_search = ef;
}

int hnsw_size(void* handle) { return static_cast<Hnsw*>(handle)->size(); }

void hnsw_add_batch(void* handle, const float* vecs, int n) {
    auto* h = static_cast<Hnsw*>(handle);
    for (int i = 0; i < n; ++i) h->add_one(vecs + (size_t)i * h->dim);
}

void hnsw_search(void* handle, const float* queries, int nq, int k,
                 int64_t* out_ids, float* out_dists) {
    auto* h = static_cast<Hnsw*>(handle);
    for (int i = 0; i < nq; ++i)
        h->search(queries + (size_t)i * h->dim, k, out_ids + (size_t)i * k,
                  out_dists + (size_t)i * k);
}

}  // extern "C"
